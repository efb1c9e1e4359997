#!/usr/bin/env python3
"""Drive the PyTorch port of ULISSE (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--series N] [--out results.json]

Phases (any failed check raises, and the script exits non-zero):
  1. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes (fused_gather_ed: B = 8 queries, rows 64 and
     512, g = 49, znorm and raw, rtol 1e-4 / atol 1e-3; mindist: B = 8
     point and interval queries against the full envelope and block
     counts, rtol 1e-6 / atol 1e-6), and the DTW path's at its shapes
     (B = 8, rows 64 and 512, qlen 160 with r = 16 and qlen 256 with
     r = 25 — the paper's Fig. 25 window of 10% of |Q| — with true
     interval queries: fused_gather_lb_keogh lb2 rtol 2e-4 / atol 2e-3,
     mu 1e-4 / 1e-4, sd 1e-3 / 1e-4; its chunk entry the same lb2, mu
     and sd bit for bit, the same survivor set (up to lb2 within the
     tolerance of kth) and counts; the LB and DP kernels' window
     normalization bit for bit against the IEEE divide at every window
     point (`gather_znorm`); dtw_survivors and the dtw_band entry rtol
     1e-4 / atol 1e-3);
  3. build the index on the card: 1,000,000 random-walk series x 256
     points (`--series` may only shrink it) at lmin=160, lmax=256,
     seg_len=16, gamma=48, card=256, znorm — the repo's bench parameters;
  4. answer batches of default-spec queries (k=5, B=8, lengths 160 and
     256) through `UlisseEngine.search`, with every kernel launch counter
     set to 0 just before and read just after;
  5. check a subset of answers against the plain-torch brute force on
     the card;
  6. time each kernel and its plain version on main-path inputs (CUDA
     events), beside the least time the card could take (its bound);
     the inputs rotate through copies larger than L2, so reads are cold;
     the scan's ED chunk entry and the partials merge at the exact
     scan's chunks under the batch's final k-th distance, the merge
     beside torch.topk over the same values (the library yardstick);
     mindist also over every envelope's PAA bounds (the PAA entry as a
     spec with use_paa_bounds runs it, 2,002,944 envelopes at full
     size), each mindist output bit-equal to its plain version;
  7. trace one batch of the main path (device busy and idle share,
     kernel launch calls and device activities a chunk step: at most 4
     calls, and no sort kernel);
  8. the DTW path: one exact DTW k-NN batch (k=5, B=8) per length through
     `UlisseEngine.search(..., QuerySpec(measure="dtw", r=r))`, counters
     set to 0 just before and read just after; every qlen-256 answer and
     the first two qlen-160 answers (DTW_BRUTE) checked against a float64
     DP brute force on the card (which keeps each query's DTW_KEEP
     nearest windows for [16]);
  9. time the DTW kernels on that path's inputs at qlen 256 (both
     lengths checked), as in 6 (the LB
     kernel's contract entry and its chunk entry, the DP's two entries,
     the dense pool merge beside torch.topk), and check LB_Keogh <= DTW
     on every survivor of one chunk;
 10. trace one DTW batch: device activities and kernel launch calls a
     chunk step, no scan kernel (the survivor pack's cumsum is gone) and
     no sort kernel (the merge's radix sort is gone); the DTW scan alone
     makes at most 4.5 kernel launch calls a step (the LB chunk entry,
     the DP, the dense merge's two kernels, the stop test's two every 8
     steps);
 11. the host backend (`scan_backend="host"`), ED and DTW: one query
     each (qlen 256), counters set to 0 just before and read just after;
     answers equal the brute-force-checked device answers of the same
     queries as (series, offset) sets, distances within 5e-3; host syncs
     per query;
 12. approx-only (`mode="approx"`), one ED and one DTW batch, counters
     around each: the k-th distance is never below the exact one, and
     the answer equals the exact one wherever `exact_from_approx` is set;
 13. time the index build's and the host backend's kernels at their
     path's inputs (qlen 256; both lengths checked), as in 6, the build
     at [14]'s shape (32 segments: the one-pass kernel's two passes of
     16, bit for bit against its plain version), and the wide DP entries
     at qlen 600, r 600;
 14. the long-query DTW path: an index of LONG_SERIES series of 1,024
     points (lmin 512, lmax 1024, seg_len 32), exact DTW k-NN at qlen
     600 with r = 600 (a band of 1,199 slots, past the warp entries';
     the build's wall printed)
     through `UlisseEngine.search` on the device backend (the wide
     survivors entry) and the host backend (the wide band entry), counters
     set to 0 just before and read just after each; answers checked
     against a float64 brute force on the card;
 15. the long-query path: an index of LQ_SERIES series of 32,768 points
     (lmin 20,000, lmax 30,000, seg_len 16) built on the card past the
     build's old staging, a batch of 8 ED queries of 29,000 points and a
     batch of 8 DTW queries of 20,000 points (r = 1% of |Q|, so that the
     phase stays short) on the device backend, past the staged chunk
     entries (their long-row variants) and past 736 segments (mindist's
     old staging), counters set to 0 just before and read just after
     each; the ED answers held to a float64 brute force on the card, the
     DTW answers to the host backend's and to a float64 DP of every
     reported window; then eps-range batches at the same lengths through
     the range entries' long-row variants (eps 1.02x the batch's median
     5th-neighbour distance; ED held to a float64 brute force, DTW to the
     host backend), counters around each; then the long-row chunk entries
     (k-NN and range modes), mindist (bit-equal to its plain version) and
     the build past 16 segments (the slab kernel; its plan, its bound
     and the cells' issue floor beside it, bit-equal to its plain
     version on the first and the last series, timed on the first, and a
     sha256 of every envelope, the digest chip_kernels.py --envelope gives on any
     tree) timed at this phase's shapes, and the batches' and the
     build's walls printed;
 16. eps-range at full size on [3]'s index: ED and DTW (r 16 / 25), B = 8
     at qlen 160 and 256 ([4]'s and [8]'s batches), each batch's eps the
     median of its queries' 64th-nearest distances (one exact k = 64
     device k-NN call); the device backend at range_capacity 2,048 and 16
     (every query with more than 16 hits overflows and finishes on the
     host, at chunk_size 4,096; DTW: [8]'s DTW_BRUTE queries), counters
     set to 0 just before and read just after each; every ED query and
     [8]'s DTW queries held to the float64 brute force (the same hits but
     windows whose float64 distance lies within 5e-3 of eps, distances
     within 5e-3), the two capacities to each other, range_overflows to
     the queries holding more hits than the buffer, one query a length
     on the host backend to the same brute force; the range entries and
     range_append held to their plain versions on the batch's pack (the
     ED entry and range_append bit for bit) and timed; the range scan
     alone traced (at most 3 kernel launch calls an ED step, 4 a DTW
     step);
 17. storage and ingestion on [3]'s index: save it to a temporary
     directory and open it cold (every stored array, in the JAX
     package's dtypes, equal to the index in memory; the payload unread
     until the first search); [4]'s first ED batch and [8]'s first DTW
     batch from the opened engine equal their answers and SearchStats;
     append APPEND_SERIES new random-walk series (the delta's envelopes
     through envelope_znorm: delta_size 2 an appended series), k-NN (ED,
     DTW) and ED range ([16]'s qlen-160 eps) batches of windows of the
     appended series find them, compact() equals build_index over every
     series on the card in every field and level, and the compacted
     engine's answers equal the uncompacted engine's; then the paged
     scans over the first PAGED_SERIES series of [3] (saved, opened
     resident and under a budget of half the payload): ED and DTW k-NN,
     ED range, and ED range at capacity 16 (an overflow finished through
     the page cache) bit-equal to the resident engine (answers and
     SearchStats), with queries/s, page hits, misses and evicted bytes,
     the seconds the scan waited on prefetch, kernel launches, and one
     traced paged ED batch's launch calls a step;
 18. serving on the card (last: its writer lane grows [3]'s engine):
     [3]'s engine behind `UlisseServer` (window 2 ms, max_batch 8):
     warmup of lengths 160, 208, 256 (12 shapes; nothing built or loaded
     by the first request after it); 64 default-spec and 16 DTW (r 25)
     requests from 8 closed-loop client threads, counters set to 0 just
     before and read just after each burst, every answer bit-equal to a
     serial engine.search of the same query, served and serial queries/s,
     dispatches, fill, queue wait and latency percentiles, the
     dispatcher's busy share and the time of a dispatch of the burst's
     most frequent fill, served and with no client thread alive;
     then 32 ED requests while 1,000 new series are appended (version 1)
     and compacted (version 2) between dispatches, answers held to a
     float64 brute force over their snapshot (the appended windows found
     after version 1); one query traced with torch annotations (the
     admission -> queue wait -> dispatch -> engine spans) and one scrape
     holding serving latency and the engine's pruning counters.
 19. the sharded search (run before [18], whose writer lane grows the
     engine [19] is held to): the four k-NN chunk entries with the sharded
     scan's mesh-wide k-th (`gkth`, half the batch's final k-th) against
     their plain versions on [3]'s index (ED staged and long-row: pools
     and counters bit for bit; LB_Keogh staged and long-row: lb2 rtol
     2e-4, mu, sd, ids and counters bit for bit, survivors at the min
     cut), the staged ones timed with and without gkth; then [3]'s
     collection written once to a temporary .npy and served by
     `UlisseEngine.distributed` in spawned worlds, each rank mmapping it:
     a world of 1 over NCCL on cuda:0 and a world of 4 over gloo (every
     rank on cuda:0, 250,000 series a shard; it checks correctness and
     the loop's overhead, not a four-card speed; --series must divide by
     4); [4]'s ED and [8]'s DTW batches as exact k-NN (the local
     engine's (sid, off) in the same order, ED within 1e-9, DTW rtol
     1e-4), and in the world of 4 [16]'s range batches at capacity 2,048
     and 16 (the local engine's hit sets but for windows within 5e-3 of
     eps), [4]'s second batch at max_leaves 1 and 64 (an answer that
     claims exactness is the exact one) and at sync_every 1 and 64 (the
     exact answer; 1 visits no more chunks); every rank's answers and
     counters equal rank 0's; queries/s per path and world, rounds a
     batch, the collectives' share of wall time (host clock), chunk
     steps a rank and shard_chunks.  The world of 4 runs first (see
     [20]).
 20. the distributed engine's writes, persistence and serving, inside
     [19]'s worlds after their searches: first the two k-NN chunk
     entries as the sharded scan's delta family runs them, with gkth
     over a rank-like [main; delta] block packed delta-first with pinned
     chunk heads (GMAP_MAIN of [3]'s series, GMAP_DELTA of [17]'s part),
     their ids mapped through its gmap, against their plain versions
     (ED pools and counters bit for bit, LB as in [19]) and timed; then
     on every rank of each world: [17]'s 10,000 series appended
     (envelope_znorm launched on every rank), [17]'s ED, DTW (r 16) and
     ED range (capacity 2,048) batches of windows of them equal to [17]'s
     local engine's answers after the same append (series ids included;
     every k-NN chunk step ran a gkth chunk entry with a gmap), a save
     (the delta with it) and a cold open in the same world whose ED and
     DTW batches equal the warm ones bit for bit with its index unbuilt
     until the first search, compact equal in every shard field to a
     fresh sharded build of the grown collection with the same
     breakpoints; the world of 4 then serves [4]'s two ED batches from
     rank 0 (4 client threads, the other ranks following) bit-equal to
     serial search and appends 1,000 series through the writer lane,
     found by the next dispatch; the world of 1 first opens the world of
     4's save (re-sharded and rebuilt: the fresh build its compact is
     held to), its ED and DTW batches equal to the local answers; world
     1's ED range runs at capacity RANGE20_WORLD1_CAP (no overflow; the
     world of 4 runs the overflow and its host tail).
 21. P5 on the card (after [19]): an index of LARGE_G_SERIES random walks
     of LARGE_G_LEN points at lmin 128, lmax 256, seg_len 16, gamma
     20,479 (g = 20,480, past the g one block of a row takes: 18,688 ED,
     13,760 LB_Keogh; 2,048 envelope rows, the long traces users index),
     searched through `UlisseEngine.search` on the device backend: ED and
     DTW (r = 10% of |Q|) k-NN and eps-range, B = 8 at qlen 128 and 256,
     counters around each (the offset-tiled long-row entries launched,
     the staged ones not); ED answers held to a float64 brute force on
     the card, DTW ones to an LB_Keogh-pruned float64 DP brute force and,
     LARGE_G_HOST queries a length, to the host backend; the tiled
     entries against their plain versions at g = 20,480, a forced tile
     of LARGE_G_FORCED_T offsets bit for bit against the untiled entries
     at g = 49, and the tiled k-NN chunk entries timed beside their
     bound.
 22. rank grids and the training collectives: the first GRID_SERIES
     series of [3] served by `UlisseEngine.distributed` over a 2 x 2
     DeviceMesh ("data", "model") in a gloo world of 4 on the one card,
     at axes ("data", "model") (4 shards) and ("data",) (2 shards x 2
     replicas): [4]'s and [8]'s second batches equal a local engine's
     over the same series on every rank; each grid's save opened under
     the other (cold) and the 2-shard save re-sharded on the group; the
     training collectives in that world and in an NCCL world of 1 against
     a plain computation.
 23. the host-sync budget (`repro_torch.analysis`) under
     `torch.cuda.set_sync_debug_mode`: [3]'s engine's local paths at B =
     1 and 8 and the delta, paged and sharded (NCCL world of 1) paths,
     every count equal to the port's own counters; then each example
     (`examples/*_torch.py`) once at its default size.  Every time is
     printed with the card's name and power limit, and each phase's
     seconds on a line as it ends.

Phase 2 also holds the scan's ED chunk entry and the partials merge
against the plain step (the contract entry's distances masked, the
counters, the stable-sort merge) over three chunks of a plan (B = 8,
rows 64 and 512, qlen 160 and 256, znorm and raw, k 5 and 500), and the
dense merge against the stable sort at M = 512 x 49: pools and counters
bit for bit.
Phase 2 also holds the slice-3 kernels against their plain versions:
envelope_znorm bit for bit (both entries; the build entry also against
the plain version on the CPU, from the same prefix sums), batch_ed at
25,088 windows, qlen 160 and 256, Qb 1 and 8, znorm and raw (rtol 2e-4 /
atol 2e-3), lb_keogh at the same windows (rtol 1e-5 / atol 1e-5).
Phase 2 also holds the wide DP entries against their plain versions at
qlen 600 / r 600 and qlen 1536 / r 1535 (rtol 1e-4 / atol 1e-3) and
against the warp entries bit for bit at W = 1023, and batch_ed (L
12,300, Qb 1; L 2,048, Qb 8) and lb_keogh (L 6,200) on long rows.
Phase 2 also holds the shapes past the old staging limits against their
plain versions (check_long_kernels): the ED and LB_Keogh entries at qlen
28,769 and 19,305 (their long-row variants; the ED step and the LB mu
and sd bit for bit), the long-row and staged kernels bit for bit at qlen
4,000, mindist at nseg 1,812 and 6,000, and the build at (lmin, lmax) =
(1,000, 14,000) and (29,000, 30,000) bit for bit.
Phase 3 builds the index through envelope_znorm (launches counted),
holds every envelope of the build against the plain version computed on
the card block by block (no element may differ), and checks on a sample
of envelopes that no lower bound exceeds the true distance.

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.  Needs one
CUDA device and nvcc; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FULL_SERIES = 1_000_000
SERIES_LEN = 256
BENCH = dict(lmin=160, lmax=256, seg_len=16, gamma=48, card=256, znorm=True)
BATCH = 8
BATCHES = 4             # query batches of BATCH on the main path
QLENS = (160, 256)
# the query length whose kernels [9] and [13] time (both lengths are
# checked; the kernels line reads this one)
TIMED_QLEN = 256
K = 5
# DTW path: (qlen, r) with r = 10% of |Q| (the paper's Fig. 25 window)
DTW_CASES = ((160, 16), (256, 25))
# the long-query DTW path: series x points, index parameters, (qlen, r)
LONG_SERIES, LONG_LEN = 128, 1024
LONG = dict(lmin=512, lmax=1024, seg_len=32, gamma=48, card=256, znorm=True)
LONG_CASE = (600, 600)
# the long-query phase: series x points, index parameters (a build past
# the card build's old staging, queries past the staged chunk entries and
# past 736 segments), the ED and DTW query lengths, and r = 1% of |Q| so
# that the DTW half stays under about a minute
LQ_SERIES, LQ_LEN = 32, 32_768
LQ = dict(lmin=20_000, lmax=30_000, seg_len=16, gamma=48, card=256,
          znorm=True)
LQ_ED, LQ_DTW = 29_000, 20_000
LQ_R = LQ_DTW // 100
# the wide DP entries timed at the long phase's (qlen, r): candidates of
# dtw_band_wide ([13]) and the chunk's candidates a query of
# dtw_survivors_wide ([15], every fourth a survivor)
LQ_DP_CANDS, LQ_DP_M = 132, 512
# [2]'s long-row checks per measure: a qlen just past the staged chunk
# entry at g = 49, and a qlen both kernels take
LONG_CHECK = {"ed": (28_769, 4_000), "dtw": (19_305, 4_000)}
# queries of each length held against the float64 DP brute force (at
# qlen 160 it takes ~100 windows per series, so only the first few)
DTW_BRUTE = {160: 2, 256: BATCH}
# the float64 brute forces' elements a block (1 GB of temporaries), and
# the DTW one's nearest windows kept a query (for [8]'s k-NN and [16]'s
# range checks)
BRUTE_ELEMS = 1 << 27
DTW_KEEP = 50_000
# [16], eps-range: each batch's eps is the median of its queries'
# RANGE_K-th nearest distances; capacities (the small one overflows and
# runs the host continuation, at RANGE_SMALL_CHUNK plan rows a chunk, on
# every ED query and the DTW queries of DTW_BRUTE); the band around eps
# in which a window's float64 distance may fall on either side (the
# card's brute-force tolerance); host-backend queries a measure
RANGE_K = 64
RANGE_CAPS = (2048, 16)
RANGE_SMALL_CHUNK = 4096
RANGE_BAND = 5e-3
RANGE_HOST = 2
# [17], storage and ingestion: series appended to the opened 1M index
# (1%), and the paged scans' series (the first of [3]'s; a budget of half
# their payload thrashes the page cache, so the count is cut for time)
APPEND_SERIES = 10_000
PAGED_SERIES = 10_000
# [18], serving: query lengths (one bucket, 256), closed-loop client
# threads, requests of the ED, DTW (at r SERVE_DTW_R) and writer-lane
# bursts, series appended under load (seed + 18), appended windows served
# again after the compact; the spans one traced served query must leave
SERVE_LENGTHS = (160, 208, 256)
SERVE_CLIENTS = 8
SERVE_ED, SERVE_DTW, SERVE_WRITE = 64, 16, 32
SERVE_DTW_R = 25
SERVE_APPEND = 1_000
SERVE_LATE = 4
SERVE_SPANS = ("serve.admission", "serve.queue_wait", "serve.dispatch",
               "query.exact_device", "prepare", "approx_pass", "pack",
               "device_scan", "merge")
# [19], the sharded search: the worlds (ranks, torch.distributed backend;
# every rank on cuda:0, so world 4 splits [3]'s collection four ways on
# the one card and checks correctness and the loop's overhead, not a
# four-card speed), the seconds a world may take, the chunk rows and the
# plan chunks of the gkth entries' checks
SHARDED_WORLDS = ((4, "gloo"), (1, "nccl"))
SHARDED_TIMEOUT_S = 600
GKTH_ROWS, GKTH_CHUNKS = 512, 8
# [20], the distributed engine's writes, persistence and serving (inside
# [19]'s worlds): the rank-like block of the gkth + gmap entries' checks
# ([3]'s first GMAP_MAIN series and GMAP_DELTA of [17]'s part: 4 delta
# chunks of GKTH_ROWS rows), the client threads of the world-4 burst and
# the series its writer lane appends (seed + 20)
GMAP_MAIN, GMAP_DELTA = 25_000, 1_000
SERVE20_CLIENTS, SERVE20_APPEND = 4, 1_000
# world 1's range capacity in [20] (world 4 keeps the default 2,048 and
# its overflow)
RANGE20_WORLD1_CAP = 1 << 18
# [21], P5 on the card: long traces (seismic, ECG) queried at a few
# hundred points, g = gamma + 1 = 20,480 past the g one block of a row
# takes (18,688 ED, 13,760 LB_Keogh), so the long-row entries tile a
# row's offsets; the queries a length also answered on the host backend
# (DTW), the chunk rows of the kernel checks, and the forced offset tile
# held bit for bit against the untiled entries at g = 49
LARGE_G = dict(lmin=128, lmax=256, seg_len=16, gamma=20_479, card=256,
               znorm=True)
LARGE_G_SERIES, LARGE_G_LEN = 1_024, 40_960
LARGE_G_QLENS = (128, 256)
LARGE_G_HOST = 1
LARGE_G_ROWS = 8
LARGE_G_FORCED_T = 16
# [22], rank grids: the first GRID_SERIES of [3]'s series on a 2 x 2 grid
GRID_SERIES = 100_000
# kernel wrappers a [19] rank counts (module, name)
SHARDED_WRAPPERS = (
    ("fused_verify", "fused_gather_ed_chunk"),
    ("fused_verify", "fused_gather_lb_keogh_chunk"),
    ("fused_verify", "fused_gather_ed_range"),
    ("fused_verify", "fused_gather_lb_keogh_range"),
    ("fused_verify", "fused_gather_ed"), ("pool_merge", "pool_merge"),
    ("pool_merge", "pool_merge_partials"), ("dtw_band", "dtw_survivors"),
    ("range_append", "range_append"), ("mindist", "mindist_sym"),
    ("envelope", "envelope_znorm"))
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2 ** 20     # H100 L2, where the device does not say
# kernel timing: traces tried before falling back to CUDA events, and the
# spin ahead of the events' loop (cycles at the H100's 1.98 GHz boost)
TRACE_TRIES = 5
# a function slower than this a call is traced one call at a time
TRACE_ONE_S = 0.02
SPIN_HZ, SPIN_MAX_S = 1.98e9, 0.1
# (rtol, atol).  LB_Keogh's mu and sd: the reference kernel test's
# tolerances (sd = sqrt(s2 / L - mu^2) cancels when |mu| >> sd, so an ulp
# of s2 / L moves sd by many).  The DTW DP: kernel and plain version run
# the same float32 recurrence; the tolerance is the one set when the plain
# version was the cumsum/cummin closed form (its float32 cumsum over the
# band cancels by up to ~1e-3 at these lengths).
# batch_ed and lb_keogh: the reference kernel tests' (sums in another
# order); envelope_znorm: bit for bit (shared IEEE arithmetic).
TOL = {"fused_gather_ed": (1e-4, 1e-3), "fused_gather_ed_long": (1e-4, 1e-3),
       "fused_gather_lb_keogh_long": (2e-4, 2e-3),
       "mindist_sym": (1e-6, 1e-6),
       "mindist_paa": (1e-6, 1e-6), "fused_gather_lb_keogh": (2e-4, 2e-3),
       "fused_gather_lb_keogh.mu": (1e-4, 1e-4),
       "fused_gather_lb_keogh.sd": (1e-3, 1e-4),
       "dtw_survivors": (1e-4, 1e-3), "dtw_band": (1e-4, 1e-3),
       "dtw_survivors_wide": (1e-4, 1e-3), "dtw_band_wide": (1e-4, 1e-3),
       "batch_ed": (2e-4, 2e-3), "lb_keogh": (1e-5, 1e-5),
       "envelope_znorm": (0.0, 0.0)}
# windows of one host-backend chunk: 512 envelopes x (gamma + 1) offsets
HOST_CHUNK_WINDOWS = 512 * (BENCH["gamma"] + 1)
REPLACES = {
    "fused_gather_ed": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                        "src/repro/kernels/fused_verify.py:181"),
    "mindist_sym": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
    "mindist_paa": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
    "fused_gather_lb_keogh": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                              "src/repro/kernels/fused_verify.py:219"),
    # the long-row variants of the two chunk entries (any qlen)
    "fused_gather_ed_long": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                             "src/repro/kernels/fused_verify.py:181"),
    "fused_gather_lb_keogh_long": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:219"),
    "dtw_survivors": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                      "src/repro/kernels/dtw_band.py:73"),
    "dtw_band": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                 "src/repro/kernels/dtw_band.py:73"),
    "dtw_survivors_wide": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                           "src/repro/kernels/dtw_band.py:73"),
    "dtw_band_wide": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                      "src/repro/kernels/dtw_band.py:73"),
    "dtw_survivors_wide_long": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                                "src/repro/kernels/dtw_band.py:73"),
    "dtw_band_wide_long": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                           "src/repro/kernels/dtw_band.py:73"),
    "envelope_znorm": ("src/repro_torch/kernels/csrc/envelope.cu",
                       "src/repro/kernels/envelope.py:65"),
    # the build past 16 segments (the slab kernel), at [15]'s index
    "envelope_znorm_long": ("src/repro_torch/kernels/csrc/envelope.cu",
                            "src/repro/kernels/envelope.py:65"),
    "batch_ed": ("src/repro_torch/kernels/csrc/batch_ed.cu",
                 "src/repro/kernels/batch_ed.py:47"),
    "lb_keogh": ("src/repro_torch/kernels/csrc/lb_keogh.cu",
                 "src/repro/kernels/lb_keogh.py:27"),
    # not a Pallas kernel: the scan's lax.top_k merge
    "pool_merge": ("src/repro_torch/kernels/csrc/pool_merge.cu",
                   "src/repro/core/executor.py:463"),
    "pool_merge_dense": ("src/repro_torch/kernels/csrc/pool_merge.cu",
                         "src/repro/core/executor.py:463"),
    # the range modes of the two chunk entries and their long-row variants
    "fused_gather_ed_range": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                              "src/repro/kernels/fused_verify.py:181"),
    "fused_gather_ed_range_long": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:181"),
    "fused_gather_lb_keogh_range": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:219"),
    "fused_gather_lb_keogh_range_long": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:219"),
    # not a Pallas kernel: the range scan's cumsum/searchsorted hit append
    "range_append": ("src/repro_torch/kernels/csrc/range_append.cu",
                     "src/repro/core/executor.py:767"),
    # the k-NN chunk entries in the sharded scan's delta family
    "fused_gather_ed_chunk_gkth_gmap": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:181"),
    "fused_gather_lb_keogh_chunk_gkth_gmap": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:219"),
    "fused_gather_ed_tiled": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:181"),
    "fused_gather_lb_keogh_tiled": (
        "src/repro_torch/kernels/csrc/fused_verify.cu",
        "src/repro/kernels/fused_verify.py:219"),
}


def log(*args, **kwargs):
    print(*args, flush=True, **kwargs)


def device_events(prof):
    """The device activity (kernels, copies, sets) of a torch.profiler
    trace, without the GPU ranges of record_function annotations."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def device_ms(prof) -> float:
    """Summed duration of a trace's device activity, ms — the card's busy
    time (one stream: the activities do not overlap)."""
    return sum(ev.time_range.elapsed_us() for ev in device_events(prof)) / 1e3


def time_calls(torch, fns, reps=20, budget_s=0.25, events=1):
    """(device ms, event ms, timer) per call over up to `reps` rounds
    through `fns` (several inputs, so a working set larger than L2 is
    read cold); a slow function (a plain version of thousands of
    launches) gets as few rounds as fit `budget_s`, at least 3.

    Device ms is the card's busy time from torch.profiler.  A trace
    sometimes records none, or only some, of a loop's device activities.
    A wrapper that makes `events` > 1 named activities a call (each
    once) is timed by the sum of their means in a trace that holds every
    name ("profiler by name"); anything else by a trace that holds at
    least `events` activities a call; after TRACE_TRIES traces that do
    neither, device ms is None.  Event ms is CUDA events around the loop,
    enqueued behind a spin of the card as long as the loop's host time
    (at most SPIN_MAX_S), so that they time the queued launches back to
    back rather than the card waiting for the host; where the launch
    queue cannot hold a loop (a plain version of thousands of launches)
    they still count those waits.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / len(fns)
    reps = max(3, min(reps, int(budget_s / max(per_call, 1e-9))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(per_call * reps, SPIN_MAX_S) * SPIN_HZ))
    start.record()
    for r in range(reps):
        fns[r % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    # a slow function (a plain version of thousands of launches) is traced
    # one call at a time: the trace's processing grows with its events
    traced = 1 if per_call > TRACE_ONE_S else reps
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for r in range(traced):
                fns[r % len(fns)]()
            torch.cuda.synchronize()
        evs = device_events(prof)
        names = {}
        for ev in evs:
            names.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        if events > 1 and len(names) == events:
            return (sum(sum(v) / len(v) for v in names.values()) / 1e3,
                    event_ms, "profiler by name")
        # every call makes at least `events` device activities
        if events == 1 and len(evs) >= traced:
            return device_ms(prof) / traced, event_ms, "profiler"
    return None, event_ms, "events"


def timing(torch, call, plain, nbytes, ops, err, shape, library=None,
           events=1, plain_ms=None):
    """One timing record: kernel and plain version (and the one PyTorch
    call computing the same function, where there is one), each by its
    device time where the profiler saw the card (else by CUDA events,
    and the record says which), beside the bound.  `events`: the device
    activities one call of the kernel's wrapper makes.  `plain_ms`: the
    plain version's time, taken by CUDA events around its one call (a
    plain wavefront of 40,000 diagonals, ~16 s a call), in place of
    timing `plain` again."""
    k_dev, k_ev, k_timer = time_calls(torch, call, events=events)
    if plain_ms is None:
        p_dev, p_ev, p_timer = time_calls(torch, plain)
    else:
        p_dev, p_ev, p_timer = None, plain_ms, "events, one call"
    lib_ms = None
    if library is not None:
        l_dev, l_ev, _ = time_calls(torch, library)
        lib_ms = l_dev or l_ev
    by_bytes = nbytes / PEAK_BYTES >= ops / PEAK_F32
    return dict(
        shape=shape, timer=k_timer, plain_timer=p_timer,
        ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
        event_ms=k_ev, plain_event_ms=p_ev, library_ms=lib_ms,
        bound_ms=max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3,
        bound_by="bytes" if by_bytes else "operations", max_abs_err=err,
        bytes=nbytes, ops=ops)


def check_close(torch, name, got, want, scale: float = 0.0):
    """Raise unless `got` matches `want` (same non-finite entries, finite
    ones within the kernel's tolerance); returns the max abs error.  The
    relative part applies to max(|want|, scale): an ED by the dot identity
    on z-normalized windows subtracts terms of size 2 qlen, and its
    float32 rounding is relative to them (pass scale = 2 qlen), not to a
    near match's small d2."""
    rtol, atol = TOL[name]
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) \
            or not torch.equal(got[~fin], want[~fin]):
        raise AssertionError(f"{name}: non-finite entries differ")
    err = (got[fin] - want[fin]).abs()
    bad = err > atol + rtol * want[fin].abs().clamp_min(scale)
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {rtol} / atol {atol}; max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def trace_batch(torch, engine, queries, spec):
    """One search call under torch.profiler: wall time, the card's busy
    time and idle share, the top device and host items."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(queries, spec)
        wall = time.perf_counter() - t0
    busy = device_ms(prof) / 1e3
    by_kernel = {}
    for ev in device_events(prof):
        row = by_kernel.setdefault(ev.name[:120], {"name": ev.name[:120],
                                                  "count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += ev.time_range.elapsed_us() / 1e3
    host = [{"name": e.key[:80], "count": e.count,
             "ms": e.self_cpu_time_total / 1e3}
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:10]]
    by_name = sorted(by_kernel.values(), key=lambda r: -r["ms"])
    return {"qlen": len(queries[0]), "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "top_self_device": by_name[:10], "device_by_name": by_name,
            "device_events": sum(r["count"] for r in by_name),
            "launch_calls": sum(e.count for e in prof.key_averages()
                                if e.key.startswith("cudaLaunchKernel")),
            "top_self_cpu": host}


def trace_scan(torch, coll, index, p, queries, spec):
    """The exact scan of one batch alone under torch.profiler: the plan
    (the queries' lower bounds over every envelope, LB-sorted) is made
    first, the scan starts from an empty pool, and the trace holds only
    the chunk loop and its result.  Returns its chunk steps, kernel
    launch calls and device activities a step, busy time and sort
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import executor, planner
    from repro_torch.kernels.fused_verify import (fused_gather_ed_chunk,
                                                  fused_gather_lb_keogh_chunk)
    dev = coll.data.device
    env = index.envelopes
    b, qlen = len(queries), len(queries[0])
    q = torch.from_numpy(np.stack(queries)).to(dev)
    qs, dlo, dhi, qb, qh = planner.prepare_query_batch(
        q, p.seg_len, p.znorm, spec.measure, spec.r)
    lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                         p.seg_len, p.query_segments(qlen),
                                         False)
    plan = planner.device_scan_pack(
        env.series_id, env.anchor, env.n_master, lbs,
        torch.full((b, 1), env.size, dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.int32, device=dev), chunk=1,
        n_pad=executor.pow2ceil(env.size))[:4]
    neg = torch.full((b, spec.k), -1, dtype=torch.int32, device=dev)
    seed = (torch.full((b, spec.k), float("inf"), device=dev), neg, neg)
    entry = (fused_gather_ed_chunk if spec.measure == "ed"
             else fused_gather_lb_keogh_chunk)
    entry.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = executor.device_exact_scan(
            coll, *plan, qs, dlo, dhi, *seed, k=spec.k, g=p.gamma + 1,
            measure=spec.measure, r=spec.r, znorm=p.znorm,
            chunk_size=spec.chunk_size)
        out[0].cpu()
        wall = time.perf_counter() - t0
    steps = entry.launches
    events = device_events(prof)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith(("cudaLaunchKernel",
                                        "cuLaunchKernel")))
    busy = device_ms(prof) / 1e3
    return {"qlen": qlen, "chunk_steps": steps, "wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "launch_calls": launches, "device_events": len(events),
            "launch_calls_per_step": launches / max(steps, 1),
            "device_events_per_step": len(events) / max(steps, 1),
            "sort_kernel_events": sum("sort" in e.name.lower()
                                      for e in events)}


def log_trace(step, tr):
    log(f"[{step}] one traced batch (qlen {tr['qlen']}): wall "
        f"{tr['wall_s']:.3f} s under the profiler, device busy "
        f"{tr['device_busy_s']:.3f} s, idle share "
        f"{tr['device_idle_share']:.3f}")
    for row in tr["top_self_device"][:6]:
        log(f"    device {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")
    for row in tr["top_self_cpu"][:6]:
        log(f"    host   {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")


def check_answers(results, k):
    """Raise unless every result holds k finite ascending distances with
    real (series, offset) ids."""
    for r in results:
        if r.dists.shape != (k,) or not np.isfinite(r.dists).all() \
                or (r.series < 0).any() or (r.offsets < 0).any():
            raise AssertionError(f"malformed result {r}")
        if not (np.diff(r.dists) >= 0).all():
            raise AssertionError("result distances not ascending")


def dtw_cells(l: int, r: int) -> int:
    """Cells of one banded DP of length l and window r inside the series."""
    r = min(r, l - 1)
    return l * (2 * r + 1) - r * (r + 1)


def gather_bytes(torch, coll, sids, anchors, qlen: int, g: int) -> int:
    """Bytes a fused-gather chunk must read from the collection: its
    distinct region elements and distinct prefix-sum positions (x4
    arrays)."""
    dev = sids.device
    n = coll.data.shape[1]
    sid, anc = sids.long(), anchors.long()
    reg = torch.arange(qlen + g - 1, device=dev)
    region = torch.unique((sid[:, None] * n + anc[:, None] + reg).clamp(
        0, coll.data.numel() - 1))
    offs = (anc[:, None] + torch.arange(g, device=dev)).clamp(0, n - qlen)
    pos = sid[:, None] * (n + 1) + offs
    sums = torch.unique(torch.cat([pos, pos + qlen]).reshape(-1))
    return region.numel() * 4 + 4 * sums.numel() * 4


def chunk_args(torch, a0, qn, dlo, dhi, plan, i: int, rows: int, cut, g: int,
               ovf=None, znorm=True, gkth=None, entry=None):
    """Chunk i of a (B, n_pad) plan through the LB_Keogh chunk entry (its
    k-NN mode under the pool's d2 `cut` (B, k), or its range mode under
    eps2 `cut` (B,) and `ovf`), as the executor's steps run it: returns
    the entry's inputs and keywords (`lb_in`, `kw`: the counters go
    last, so the plain version gets a copy), its outputs, the counters it
    added, and the `dtw_survivors` arguments it leaves (its survivors'
    list and count, the candidates, mu, sd, and the DP output, +inf at
    every non-survivor).  `gkth` (k-NN): the sharded scan's mesh-wide
    k-th, in `kw`; `entry` another k-NN entry (the long-row variant)."""
    from repro_torch.kernels.fused_verify import (fused_gather_lb_keogh_chunk,
                                                  fused_gather_lb_keogh_range)
    b = dlo.shape[0]
    lb_in = (*a0, *plan, dlo, dhi, cut) + (() if ovf is None else (ovf,))
    kw = dict(i=i, chunk=rows, g=g, znorm=znorm)
    if gkth is not None:
        kw["gkth"] = gkth
    stats = torch.zeros((b, 6), dtype=torch.int32, device=dlo.device)
    entry = entry or (fused_gather_lb_keogh_chunk if ovf is None
                      else fused_gather_lb_keogh_range)
    out = entry(*lb_in, stats, **kw)
    _, mu, sd, slist, nsurv, d2, cand_sid, cand_off = out
    return lb_in, kw, out, stats, (a0[0], qn, slist, nsurv, cand_sid,
                                   cand_off, mu.reshape(b, -1),
                                   sd.reshape(b, -1), d2)


def row_plan(torch, sids, anchors, n_master):
    """A one-chunk plan of (B, rows) envelope rows, every bound 0: the
    chunk entries then keep every row of a query whose cut is above 0."""
    return (sids.contiguous(), anchors.contiguous(), n_master.contiguous(),
            torch.zeros(sids.shape, device=sids.device))


def check_chunk_entry(torch, lb_in, kw, got, stats, range_mode=False):
    """Hold the LB chunk entry's outputs (`chunk_args`) against its plain
    version on the same inputs: lb2 within the LB tolerance (the same
    +inf), mu, sd and every candidate's (sid, off) bit-equal, the
    counters equal (the survivor columns the kernel's own count), the
    same survivor set up to lb2 within the tolerance of the cut, nsurv
    its size, the list a permutation of it, and +inf in the DP's output
    at every non-survivor.  Returns (max abs err of lb2, survivors)."""
    from repro_torch.kernels import ref
    plain = (ref.fused_gather_lb_keogh_range_ref if range_mode
             else ref.fused_gather_lb_keogh_chunk_ref)
    st_plain = torch.zeros_like(stats)
    want = plain(*lb_in, st_plain, **kw)
    err = check_close(torch, "fused_gather_lb_keogh", got[0], want[0])
    for name, x, y in (("mu", got[1], want[1]), ("sd", got[2], want[2]),
                       ("cand_sid", got[6], want[6]),
                       ("cand_off", got[7], want[7])):
        check_equal(torch, f"fused_gather_lb_keogh_chunk.{name}", x, y)
    b = stats.shape[0]
    cut = lb_in[-2] if range_mode else lb_in[-1][:, -1]
    if "gkth" in kw:
        cut = torch.minimum(cut, kw["gkth"])
    rtol, atol = TOL["fused_gather_lb_keogh"]
    ok = torch.isfinite(want[0].reshape(b, -1))

    def below(lb):
        return ok & (lb <= cut[:, None] if range_mode else lb < cut[:, None])
    surv = below(got[0].reshape(b, -1))
    plain_lb = want[0].reshape(b, -1)
    near = (plain_lb - cut[:, None]).abs() <= atol + rtol * cut.abs()[:, None]
    if not bool((near | (surv == below(plain_lb))).all()):
        raise AssertionError("LB chunk entry: survivor set differs")
    if not torch.equal(got[4], surv.sum(dim=1, dtype=torch.int32)):
        raise AssertionError("LB chunk entry: nsurv is not the set's size")
    for i in range(b):
        listed = got[3][i, :int(got[4][i])].long().sort().values
        if not torch.equal(listed, surv[i].nonzero()[:, 0]):
            raise AssertionError("LB chunk entry: list is not the set")
    if not bool(torch.isinf(got[5][~surv]).all()):
        raise AssertionError("LB chunk entry: DP output not +inf off the "
                             "survivors")
    cols = [0, 1, 3, 5]
    check_equal(torch, "LB chunk entry counters", stats[:, cols],
                st_plain[:, cols])
    for c in (2, 4):
        check_equal(torch, "LB chunk entry survivor counters", stats[:, c],
                    got[4])
    return err, int(got[4].sum())


def ed_step_pair(torch, a0, plan, qs, pool, plain, stats, stats_plain, i,
                 rows, g, znorm, gkth=None, entry=None, gmap=None):
    """Chunk i of an ED plan through the chunk entry and the partials
    merge (pool, stats) and through the plain step fed the contract
    entry's distances (plain, stats_plain), all in place; raise unless
    the pools and counters are equal bit for bit.  Returns the chunk
    entry's partials.  `gkth`: both steps take the sharded scan's
    mesh-wide k-th; `entry` another chunk entry (the long-row one);
    `gmap`: both map the partials' ids through it before the merge, as
    the sharded scan's delta family does (`executor._scan_chunk_step`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import (fused_gather_ed,
                                                  fused_gather_ed_chunk)
    from repro_torch.kernels.pool_merge import pool_merge_partials
    cols = slice(i * rows, (i + 1) * rows)
    dist = fused_gather_ed(*a0, plan[0][:, cols].reshape(-1).contiguous(),
                           plan[1][:, cols].reshape(-1).contiguous(), qs,
                           g=g, rows=rows, znorm=znorm)
    part = ref.fused_gather_ed_chunk_ref(*a0, *plan, qs, plain[0],
                                         stats_plain, i=i, chunk=rows, g=g,
                                         znorm=znorm, dist=dist, gkth=gkth)
    if gmap is not None:
        part[1] = gmap[part[1].long()]
    for t, v in zip(plain, ref.pool_merge_partials_ref(plain, part)):
        t.copy_(v)
    part = (entry or fused_gather_ed_chunk)(
        *a0, *plan, qs, pool[0], stats, i=i, chunk=rows, g=g, znorm=znorm,
        **({} if gkth is None else {"gkth": gkth}))
    if gmap is not None:
        part[1] = gmap[part[1].long()]
    pool_merge_partials(pool, part)
    for name, x, y in zip(("d2", "sid", "off"), pool, plain):
        check_equal(torch, f"ED chunk step pool {name}", x, y)
    check_equal(torch, "ED chunk step counters", stats, stats_plain)
    return part


def check_ed_step(torch, dev, probe, rng, g):
    """The ED chunk entry + partials merge against the plain step over
    three chunks of a plan on the probe collection (B = 8, rows 64 and
    512, qlen 160 and 256, znorm and raw, k 5 and 500): anchors on the
    envelope grid, random n_master, every fifth row a copy of its
    neighbour (equal d2 at two positions), query 0 all padding, lbs2
    rising to ~1.2x each query's median distance, a seed pool half made
    of candidate distances (ties with newcomers); and the dense merge
    against the stable sort at the DTW branch's (B, 512 x g) rows over
    four rounds with ties, k 5 and 500.  Returns the steps held."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import fused_gather_ed
    from repro_torch.kernels.pool_merge import pool_merge
    s_probe, n = probe.data.shape
    a0 = (probe.data, probe.csum, probe.csum2, probe.csum_lo,
          probe.csum2_lo, probe.center)
    held = 0

    def seed(d2_all, k):
        d2 = torch.full((BATCH, k), float("inf"), device=dev)
        sid = torch.full((BATCH, k), -1, dtype=torch.int32, device=dev)
        for q in range(BATCH):
            m = k // 2
            pick = d2_all[q][torch.randperm(d2_all.shape[1], device=dev)[:m]]
            d2[q, :m] = pick.sort().values
            sid[q, :m] = 10 ** 7 + torch.arange(m, device=dev)
        return [d2, sid, sid.clone()]

    for rows in (64, 512):
        n_pad = 3 * rows
        for qlen in QLENS:
            qs = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
                np.float32)).to(dev)
            sids = rng.integers(0, s_probe, (BATCH, n_pad)).astype(np.int32)
            anc = (rng.integers(0, 2, (BATCH, n_pad)) * g).astype(np.int32)
            nm = rng.integers(0, g + 1, (BATCH, n_pad)).astype(np.int32)
            copy = np.arange(1, n_pad, 5)
            sids[:, copy], anc[:, copy] = sids[:, copy - 1], anc[:, copy - 1]
            sids, anc, nm = (torch.from_numpy(x).to(dev)
                             for x in (sids, anc, nm))
            for znorm in (True, False):
                d2_all = fused_gather_ed(*a0, sids.reshape(-1),
                                         anc.reshape(-1), qs, g=g,
                                         rows=n_pad, znorm=znorm)
                d2_all = d2_all.reshape(BATCH, -1)
                med = d2_all.median(dim=1).values
                lbs2 = (torch.from_numpy(np.sort(rng.random(
                    (BATCH, n_pad)), axis=1).astype(np.float32)).to(dev)
                    * 1.2 * med[:, None])
                lbs2[0] = float("inf")
                plan = (sids, anc, nm, lbs2)
                for k in (K, 500):
                    pool = seed(d2_all, k)
                    plain = [t.clone() for t in pool]
                    st = torch.zeros((BATCH, 6), dtype=torch.int32,
                                     device=dev)
                    st_plain = st.clone()
                    for i in range(3):
                        ed_step_pair(torch, a0, plan, qs, pool, plain, st,
                                     st_plain, i, rows, g, znorm)
                        held += 1
    m = 512 * g
    for k in (K, 500):
        pool = [torch.full((BATCH, k), float("inf"), device=dev),
                torch.full((BATCH, k), -1, dtype=torch.int32, device=dev),
                torch.full((BATCH, k), -1, dtype=torch.int32, device=dev)]
        plain = [t.clone() for t in pool]
        for rnd in range(4):
            d2 = torch.from_numpy(rng.integers(0, 400, (BATCH, m)).astype(
                np.float32)).to(dev)
            d2[torch.rand((BATCH, m), device=dev) > 0.02] = float("inf")
            if rnd:
                d2[:, :k] = torch.where(torch.isfinite(plain[0]), plain[0],
                                        d2[:, :k])
            sid, off = (torch.from_numpy(rng.integers(
                0, 10 ** 6, (BATCH, m)).astype(np.int32)).to(dev)
                for _ in range(2))
            for t, v in zip(plain, ref.pool_merge_ref(plain, d2, sid, off)):
                t.copy_(v)
            pool_merge(pool, d2, sid, off)
            for name, x, y in zip(("d2", "sid", "off"), pool, plain):
                check_equal(torch, f"dense pool merge {name}", x, y)
            held += 1
    return held


def merge_work(torch, pool_d2, d2):
    """(bytes, live): what a merge must move — the pool read and written,
    every candidate's d2 read, and the sid and off of the candidates
    below the pool's k-th (the live ones, which alone can enter)."""
    b, k = pool_d2.shape
    live = int((d2 < pool_d2[:, -1:]).sum())
    return 2 * 3 * b * k * 4 + d2.numel() * 4 + live * 8, live


def ok_reads(torch, coll, plan, active_of, cut, inclusive: bool, qlen: int,
             rows: int, g: int, n_chunks: int, every_sum: bool = False):
    """(bytes read from the collection, ok candidates) of one chunk-entry
    call, averaged over the plan's first n_chunks chunks: query b active
    at chunk i where active_of(i)[b], a row kept at lbs2 < cut[b] (<= when
    inclusive), the ok candidates by `ref.chunk_candidates`.  Reads: the
    ok candidates' distinct window elements and the distinct prefix-sum
    positions (x4 arrays) of the ok candidates, or of every candidate with
    every_sum (the LB_Keogh entries write every candidate's mu and sd)."""
    from repro_torch.kernels import ref
    dev = cut.device
    n = coll.data.shape[1]
    sids, anc, nm, lbs2 = plan
    span = torch.arange(qlen, device=dev)
    read, n_ok = 0, 0
    for i in range(n_chunks):
        sl = slice(i * rows, (i + 1) * rows)
        clb2 = lbs2[:, sl]
        below = clb2 <= cut[:, None] if inclusive else clb2 < cut[:, None]
        keep = below & active_of(i)[:, None]
        ok, cs, co = ref.chunk_candidates(sids[:, sl], anc[:, sl],
                                          nm[:, sl], keep, qlen, n, g)
        s_ok, o_ok = cs[ok].long(), co[ok].long()
        elems = torch.unique((s_ok[:, None] * n + o_ok[:, None] + span)
                             .reshape(-1))
        if every_sum:
            pos = cs.long() * (n + 1) + co.long().clamp(0, n - qlen)
        else:
            pos = s_ok * (n + 1) + o_ok
        sums = torch.unique(torch.cat([pos, pos + qlen]).reshape(-1))
        read += elems.numel() * 4 + 4 * sums.numel() * 4
        n_ok += int(ok.sum())
    return read / n_chunks, n_ok / n_chunks


def ed_chunk_work(torch, coll, plan, pool_d2, qlen: int, rows: int, g: int,
                  n_chunks: int, gkth=None, long: bool = False):
    """(bytes, flops, ok candidates) one call of the ED chunk entry needs,
    averaged over the plan's first n_chunks chunks under pool_d2: the
    chunk's plan entries, the pool, the counters read and written, the
    queries, the ok candidates' reads (`ok_reads`), the partials written;
    2 qlen flops an ok candidate (`gkth`: the sharded scan's cut, the
    min of the pool's k-th and it; `long`: the long-row entry's partials,
    a list a (row block, offset tile))."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import ed_chunk_tile, offset_tile
    lbs2 = plan[3]
    b, k = pool_d2.shape
    read, n_ok = ok_reads(
        torch, coll, plan,
        lambda i: ref.scan_active(lbs2, pool_d2, i, rows, gkth),
        ref.knn_cut(pool_d2, gkth), False, qlen, rows, g, n_chunks)
    sms = torch.cuda.get_device_properties(
        pool_d2.device).multi_processor_count
    tile = ed_chunk_tile(qlen, g, long, batch=b, rows=rows, sms=sms)
    t = offset_tile("ed", qlen, g) if long else g
    parts = 4 * b * -(-rows // tile) * -(-g // t) * min(k, tile * t) * 4
    nbytes = (read + b * rows * 16 + b * k * 4 + 2 * b * 6 * 4
              + b * qlen * 4 + parts)
    return nbytes, 2 * qlen * n_ok, n_ok


def range_chunk_work(torch, coll, plan, eps2, qlen: int, rows: int, g: int,
                     n_chunks: int):
    """(bytes, flops, ok candidates) one call of the ED range entry needs,
    averaged over the pack's first n_chunks chunks: the chunk's plan
    entries, eps2, ovf and the counters, the queries, the ok candidates'
    reads (`ok_reads`), the dense d2 written; 2 qlen flops an ok
    candidate."""
    from repro_torch.kernels import ref
    lbs2 = plan[3]
    b = eps2.shape[0]
    ovf = torch.full((b,), lbs2.shape[1] // rows, dtype=torch.int32,
                     device=eps2.device)
    read, n_ok = ok_reads(
        torch, coll, plan,
        lambda i: ref.range_active(lbs2, eps2, ovf, i, rows), eps2, True,
        qlen, rows, g, n_chunks)
    nbytes = (read + b * rows * 16 + 2 * b * 4 + 2 * b * 6 * 4
              + b * qlen * 4 + b * rows * g * 4)
    return nbytes, 2 * qlen * n_ok, n_ok


def lb_chunk_work(torch, coll, plan, cut, qlen: int, rows: int, g: int,
                  n_chunks: int, surv: float, ovf=None, gkth=None):
    """(bytes, flops, ok candidates) one call of the LB_Keogh chunk entry
    needs, averaged over the plan's first n_chunks chunks: k-NN under the
    pool's d2 `cut` (B, k), or range under eps2 `cut` (B,) and `ovf`.
    Bytes: the chunk's plan entries, the cut, ovf and the counters, the
    DTW envelopes, the ok candidates' window elements and every
    candidate's prefix-sum positions (`ok_reads`), the dense lb2, mu, sd,
    DP output and (sid, off) written, and the `surv` survivors listed a
    call.  Flops: 10 a point of an ok candidate (subtract, divide, two
    subtracts, two max, two multiplies, two adds); the entry computes
    every candidate, but only the ok ones' LB is its result."""
    from repro_torch.kernels import ref
    lbs2 = plan[3]
    b = lbs2.shape[0]
    if ovf is None:
        read, n_ok = ok_reads(
            torch, coll, plan,
            lambda i: ref.scan_active(lbs2, cut, i, rows, gkth),
            ref.knn_cut(cut, gkth), False, qlen, rows, g, n_chunks,
            every_sum=True)
    else:
        read, n_ok = ok_reads(
            torch, coll, plan,
            lambda i: ref.range_active(lbs2, cut, ovf, i, rows), cut, True,
            qlen, rows, g, n_chunks, every_sum=True)
    m = b * rows * g
    nbytes = (read + b * rows * 16 + 2 * b * 4 + 2 * b * 6 * 4
              + 2 * b * qlen * 4 + 6 * m * 4 + b * 4 + surv * 4)
    return nbytes, 10 * qlen * n_ok, n_ok


def sort_events(tr):
    """Device activities of a traced batch whose kernel name says sort."""
    return sum(row["count"] for row in tr["device_by_name"]
               if "sort" in row["name"].lower())


def check_dtw_kernels(torch, dev, p, probe, rng):
    """The DTW path's kernels against their plain versions at its shapes;
    returns the max abs error of each, the share of LB_Keogh's mu and sd
    entries that are bit-equal to the plain version's (both entries), and
    the count of window points whose normalization (`gather_znorm`, the
    LB and DP kernels' arithmetic) differs from the IEEE divide, of how
    many."""
    from repro_torch.core import planner
    from repro_torch.core.paa import znormalize
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors
    from repro_torch.kernels.fused_verify import (fused_gather_lb_keogh,
                                                  gather_znorm)
    g = p.gamma + 1
    s_probe, n = probe.data.shape
    a0 = (probe.data, probe.csum, probe.csum2, probe.csum_lo,
          probe.csum2_lo, probe.center)
    errs = dict.fromkeys(("fused_gather_lb_keogh", "fused_gather_lb_keogh.mu",
                          "fused_gather_lb_keogh.sd", "dtw_survivors",
                          "dtw_band"), 0.0)
    same, total, w_differ, w_points = 0, 0, 0, 0

    def close(name, got, want):
        errs[name] = max(errs[name], check_close(torch, name, got, want))

    for qlen, r in DTW_CASES:
        q = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
            np.float32)).to(dev)
        qn, dlo, dhi, _, _ = planner.prepare_query_batch(
            q, p.seg_len, True, "dtw", r)
        for rows in (64, 512):
            sids = torch.from_numpy(rng.integers(
                0, s_probe, BATCH * rows).astype(np.int32)).to(dev)
            anc = torch.from_numpy(rng.integers(
                0, n - qlen + 1, BATCH * rows).astype(np.int32)).to(dev)
            for znorm in (False, True):
                got = fused_gather_lb_keogh(*a0, sids, anc, dlo, dhi, g=g,
                                            rows=rows, znorm=znorm)
                want = ref.fused_gather_lb_keogh_ref(
                    *a0, sids, anc, dlo, dhi, g=g, rows=rows, znorm=znorm)
                for suffix, x, y in zip(("", ".mu", ".sd"), got, want):
                    close("fused_gather_lb_keogh" + suffix, x, y)
                for x, y in zip(got[1:], want[1:]):
                    same += int((x == y).sum())
                    total += x.numel()
                # every window point: the kernels' w against the divide
                w = gather_znorm(probe.data, sids, anc, got[1], got[2],
                                 qlen=qlen, g=g)
                w_ref = ref.gather_znorm_ref(probe.data, sids, anc, got[1],
                                             got[2], qlen=qlen, g=g)
                w_differ += int((w.view(torch.int32)
                                 != w_ref.view(torch.int32)).sum())
                w_points += w.numel()
                del w, w_ref
            # the scan's chunk entry and the DP over its survivors (znorm):
            # each query keeps about its 600 least lower bounds, query 0
            # none
            # (k-NN: query 0 inactive; range: query 0 at eps2 = 0, query 1
            # overflowed)
            kth = got[0].reshape(BATCH, -1).sort(dim=1).values[:, 600]
            kth[0] = -float("inf")
            csid = sids.reshape(BATCH, rows)
            plan = row_plan(torch, csid, anc.reshape(BATCH, rows),
                            torch.full_like(csid, g))
            eps2 = kth.contiguous().clone()
            eps2[0] = 0.0
            ovf = torch.ones(BATCH, dtype=torch.int32, device=dev)
            ovf[1] = 0
            for cut, o in ((kth[:, None].contiguous(), None), (eps2, ovf)):
                lb_in, kw, out, st, dp = chunk_args(
                    torch, a0, qn, dlo, dhi, plan, 0, rows, cut, g, ovf=o)
                err, _ = check_chunk_entry(torch, lb_in, kw, out, st,
                                           range_mode=o is not None)
                errs["fused_gather_lb_keogh"] = max(
                    errs["fused_gather_lb_keogh"], err)
                close("dtw_survivors",
                      dtw_survivors(*dp[:-1], dp[-1].clone(), r=r,
                                    znorm=True),
                      ref.dtw_survivors_ref(*dp[:-1], dp[-1].clone(), r=r,
                                            znorm=True))
        # the function entry: q_0 against 4096 z-normalized windows
        cands = znormalize(probe.data[:, :qlen]).contiguous()
        close("dtw_band", dtw_band(qn[0].contiguous(), cands, r),
              ref.dtw_band_ref(qn[0], cands, r))
    return errs, same / total, (w_differ, w_points)


def survivor_inputs(torch, dev, rng, data, qlen: int, b: int = BATCH,
                    m: int = 512):
    """One chunk's DP inputs on `data` (S, n): B queries, M candidates at
    random (series, offset), every fourth one a survivor, listed in a
    shuffled order; the DP output +inf elsewhere."""
    s, n = data.shape
    surv = rng.random((b, m)) < 0.25
    slist = np.zeros((b, m), np.int32)
    for i in range(b):
        pos = rng.permutation(np.nonzero(surv[i])[0])
        slist[i, :len(pos)] = pos
    t = [torch.from_numpy(x).to(dev) for x in (
        rng.normal(size=(b, qlen)).astype(np.float32), slist,
        surv.sum(1).astype(np.int32),
        rng.integers(0, s, (b, m)).astype(np.int32),
        rng.integers(0, n - qlen + 1, (b, m)).astype(np.int32),
        rng.normal(size=(b, m)).astype(np.float32),
        (rng.random((b, m)) + 0.5).astype(np.float32),
        np.where(surv, np.nan, np.inf).astype(np.float32))]
    return (data, *t[:-1]), t[-1]


def check_wide_kernels(torch, dev, rng):
    """The shapes past the warp entries and the host kernels' staging:
    the wide DP entries against their plain versions bit for bit at qlen
    600 / r 600 and qlen 1536 / r 1535, and against the warp entries at
    W = 1023; batch_ed (L 12,300, Qb 1; L 2,048, Qb 8) and lb_keogh
    (L 6,200).  Returns the max abs error of each."""
    from repro_torch.core import dtw
    from repro_torch.kernels import ref
    from repro_torch.kernels.batch_ed import batch_ed
    from repro_torch.kernels.dtw_band import (dtw_band, dtw_band_wide,
                                              dtw_survivors,
                                              dtw_survivors_wide)
    from repro_torch.kernels.lb_keogh import lb_keogh
    errs = dict.fromkeys(("dtw_band_wide", "dtw_survivors_wide",
                          "batch_ed", "lb_keogh"), 0.0)
    data = torch.from_numpy(np.cumsum(rng.normal(size=(256, 2048)), -1)
                            .astype(np.float32)).to(dev)
    for qlen, r, n_cand in ((600, 600, 512), (1536, 1535, 32)):
        q = torch.from_numpy(rng.normal(size=qlen).astype(np.float32)).to(dev)
        c = torch.from_numpy(rng.normal(size=(n_cand, qlen)).astype(
            np.float32)).to(dev)
        check_equal(torch, "dtw_band_wide", dtw_band_wide(q, c, r),
                    ref.dtw_band_ref(q, c, r))
        args, d2 = survivor_inputs(torch, dev, rng, data, qlen,
                                   m=256 if qlen < 1000 else 32)
        check_equal(torch, "dtw_survivors_wide",
                    dtw_survivors_wide(*args, d2.clone(), r=r, znorm=True),
                    ref.dtw_survivors_ref(*args, d2.clone(), r=r,
                                          znorm=True))
    # W = 1023: both entries take it, with the same bits
    q = torch.from_numpy(rng.normal(size=700).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(256, 700)).astype(np.float32)
                         ).to(dev)
    check_equal(torch, "dtw_band warp vs wide entry at W = 1023",
                dtw_band(q, c, 511), dtw_band_wide(q, c, 511))
    args, d2 = survivor_inputs(torch, dev, rng, data, 600, m=256)
    check_equal(torch, "dtw_survivors warp vs wide entry at W = 1023",
                dtw_survivors(*args, d2.clone(), r=511, znorm=True),
                dtw_survivors_wide(*args, d2.clone(), r=511, znorm=True))
    for l, qb in ((12_300, 1), (2_048, 8)):
        w = torch.from_numpy((rng.normal(size=(2_000, l)) * 3 + 1).astype(
            np.float32)).to(dev)
        qs = torch.from_numpy(rng.normal(size=(qb, l)).astype(np.float32)
                              ).to(dev)
        for znorm in (False, True):
            errs["batch_ed"] = max(errs["batch_ed"], check_close(
                torch, "batch_ed", batch_ed(w, qs, znorm),
                ref.batch_ed_ref(w, qs, znorm)))
    w = torch.from_numpy(rng.normal(size=(2_000, 6_200)).astype(np.float32)
                         ).to(dev)
    lo, hi = dtw.dtw_envelope(torch.from_numpy(rng.normal(size=6_200).astype(
        np.float32)).to(dev), 620)
    errs["lb_keogh"] = check_close(torch, "lb_keogh",
                                   lb_keogh(lo.contiguous(), hi.contiguous(),
                                            w),
                                   ref.lb_keogh_ref(lo, hi, w))
    return errs


def check_build_envelopes(torch, coll, index, p) -> dict:
    """Every valid envelope of the built index against the plain version
    of the build, computed on the card from the same prefix sums over the
    build's own blocks: the number of (lo, hi) elements that differ (none
    may)."""
    from repro_torch.core import envelope as core_envelope
    from repro_torch.kernels import ref
    s, n = coll.data.shape
    n_env, g = p.num_envelopes(n), p.gamma + 1
    block = max(1, core_envelope.build_block_series(n, p, coll.device))
    env = index.envelopes
    ok = env.valid
    rows = (env.series_id.long() * n_env + env.anchor.long() // g)[ok]
    built_lo, built_hi = env.paa_lo[ok], env.paa_hi[ok]
    differ, checked = 0, 0
    kw = dict(lmin=p.lmin, lmax=p.lmax, gamma=p.gamma, seg_len=p.seg_len)
    for start in range(0, s, block):
        stop = min(start + block, s)
        plain = ref.envelope_znorm_ref(
            *core_envelope.centered_prefixes(coll.data[start:stop]), **kw)
        mine = (rows >= start * n_env) & (rows < stop * n_env)
        at = rows[mine] - start * n_env
        for built, want in zip((built_lo[mine], built_hi[mine]), plain):
            differ += int((built != want.reshape(-1, p.w)[at]).sum())
            checked += built.numel()
        del plain
    return {"checked": checked, "differ": differ, "blocks": -(-s // block)}


def brute64_dtw(torch, data, q, k: int, r: int, znorm: bool):
    """Exact DTW k-NN on the card in float64 (`brute64_dtw_lb`):
    (series, offsets, dists)."""
    n_off = data.shape[1] - len(q) + 1
    idx, d = brute64_dtw_lb(torch, data, q, r, znorm, k=k)
    return idx // n_off, idx % n_off, d


def envelope_work(p, n: int):
    """Per series of length n: (valid (master, l', segment) cells,
    valid (master, l') pairs, (master, segment) pairs with a cell) of the
    Z-normalized build — what `envelope_znorm` computes."""
    off = np.arange(p.num_envelopes(n) * (p.gamma + 1))
    off = off[off + p.lmin <= n]
    longest = np.minimum(p.lmax, n - off)[:, None]
    first = np.maximum(p.lmin, (np.arange(p.w) + 1) * p.seg_len)[None, :]
    per = np.maximum(longest - first + 1, 0)
    return (int(per.sum()), int((longest - p.lmin + 1).sum()),
            int((per > 0).sum()))


def timed_call(torch, fn):
    """(fn(), its ms by CUDA events): one call of a slow plain version,
    checked and timed at once."""
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return out, ev0.elapsed_time(ev1)


def check_equal(torch, name, got, want):
    """Raise unless `got` equals `want` value for value (bit for bit up to
    the sign of zero); returns 0.0, the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{name}: not equal to its plain version")
    return 0.0


def probe_windows(torch, probe, rng, qlen: int):
    """HOST_CHUNK_WINDOWS windows of length qlen of the probe collection
    at random (series, offset): one host chunk's worth."""
    s, n = probe.data.shape
    dev = probe.data.device
    sid = torch.from_numpy(rng.integers(0, s, HOST_CHUNK_WINDOWS)).to(dev)
    off = torch.from_numpy(rng.integers(0, n - qlen + 1,
                                        HOST_CHUNK_WINDOWS)).to(dev)
    return probe.data.unfold(1, qlen, 1)[sid, off].contiguous()


def check_long_kernels(torch, dev, rng, g):
    """The shapes past the old staging limits against their plain
    versions: the ED and LB_Keogh contract entries at a qlen past the
    staged kernels (LONG_CHECK: they hand the call to the long-row
    variants), the chunk entries there (ED: the chunk entry and the
    partials merge bit-equal to the plain step over three chunks; LB:
    check_chunk_entry), the long-row and staged kernels bit for bit at a
    qlen both take, mindist at B = 8 and nseg 1,812 (the long phase's ED
    queries: opt-in shared memory) and 6,000 (past 227 KB: the query
    intervals read in place), and the card build past its staging
    ((lmin, lmax) = (1,000, 14,000) and (29,000, 30,000)) bit for bit.
    Returns the max abs error of each."""
    from repro_torch.core import Collection, dtw
    from repro_torch.core.envelope import _prefix
    from repro_torch.kernels import ref
    from repro_torch.kernels.envelope import envelope_znorm
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed, fused_gather_ed_long, fused_gather_lb_keogh,
        fused_gather_lb_keogh_long, staged)
    from repro_torch.kernels.mindist import mindist_paa, mindist_sym
    errs = dict.fromkeys(("fused_gather_ed_long", "fused_gather_lb_keogh_long",
                          "mindist_sym", "mindist_paa"), 0.0)
    b, rows = 4, 16
    for measure, (qlen, both) in LONG_CHECK.items():
        if staged(measure, qlen, g) or not staged(measure, both, g):
            raise AssertionError(f"{measure}: the staged kernel takes qlen "
                                 f"{qlen}, or not {both}")
        n = qlen + 200
        coll = Collection.from_array(np.cumsum(rng.normal(
            size=(8, n)), -1).astype(np.float32), device=dev)
        a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo,
              coll.csum2_lo, coll.center)
        q = torch.from_numpy(rng.normal(size=(b, qlen)).astype(
            np.float32)).to(dev)
        sids = torch.from_numpy(rng.integers(0, 8, (b, 3 * rows)).astype(
            np.int32)).to(dev)
        anc = torch.from_numpy((rng.integers(0, 5, (b, 3 * rows)) * g)
                               .astype(np.int32)).to(dev)
        rs, ra = (t[:, :rows].reshape(-1).contiguous() for t in (sids, anc))
        if measure == "ed":
            errs["fused_gather_ed_long"] = check_close(
                torch, "fused_gather_ed_long",
                fused_gather_ed(*a0, rs, ra, q, g=g, rows=rows, znorm=True),
                ref.fused_gather_ed_ref(*a0, rs, ra, q, g=g, rows=rows,
                                        znorm=True))
            nm = torch.from_numpy(rng.integers(0, g + 1, (b, 3 * rows))
                                  .astype(np.int32)).to(dev)
            d2_all = fused_gather_ed(*a0, sids.reshape(-1), anc.reshape(-1),
                                     q, g=g, rows=3 * rows, znorm=True)
            med = d2_all.reshape(b, -1).median(dim=1).values
            lbs2 = (torch.from_numpy(np.sort(rng.random((b, 3 * rows)),
                                             axis=1).astype(np.float32))
                    .to(dev) * 1.2 * med[:, None])
            pool = [torch.full((b, K), float("inf"), device=dev),
                    *(torch.full((b, K), -1, dtype=torch.int32, device=dev)
                      for _ in range(2))]
            plain = [t.clone() for t in pool]
            st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
            st_plain = st.clone()
            for i in range(3):
                ed_step_pair(torch, a0, (sids, anc, nm, lbs2), q, pool,
                             plain, st, st_plain, i, rows, g, True)
            qb = q[:, :both].contiguous()
            check_equal(torch, "fused_gather_ed long-row vs staged kernel",
                        fused_gather_ed_long(*a0, rs, ra, qb, g=g, rows=rows,
                                             znorm=True),
                        fused_gather_ed(*a0, rs, ra, qb, g=g, rows=rows,
                                        znorm=True))
        else:
            lo, hi = (t.contiguous()
                      for t in dtw.dtw_envelope(q, qlen // 100))
            got = fused_gather_lb_keogh(*a0, rs, ra, lo, hi, g=g, rows=rows,
                                        znorm=True)
            want = ref.fused_gather_lb_keogh_ref(*a0, rs, ra, lo, hi, g=g,
                                                 rows=rows, znorm=True)
            err = check_close(torch, "fused_gather_lb_keogh_long", got[0],
                              want[0])
            for name, x, y in zip(("mu", "sd"), got[1:], want[1:]):
                check_equal(torch, f"fused_gather_lb_keogh_long.{name}", x, y)
            kth = got[0].reshape(b, -1).sort(dim=1).values[:, rows * g // 10]
            kth[0] = -float("inf")
            plan = row_plan(torch, sids[:, :rows], anc[:, :rows],
                            torch.full((b, rows), g, dtype=torch.int32,
                                       device=dev))
            errs["fused_gather_lb_keogh_long"] = err
            ovf = torch.ones(b, dtype=torch.int32, device=dev)
            for cut, o in ((kth[:, None].contiguous(), None),
                           (kth.contiguous(), ovf)):
                lb_in, kw, out, st, _ = chunk_args(
                    torch, a0, q, lo, hi, plan, 0, rows, cut, g, ovf=o)
                c_err, _ = check_chunk_entry(torch, lb_in, kw, out, st,
                                             range_mode=o is not None)
                errs["fused_gather_lb_keogh_long"] = max(
                    errs["fused_gather_lb_keogh_long"], c_err)
            lo, hi = (t[:, :both].contiguous() for t in (lo, hi))
            for x, y in zip(fused_gather_lb_keogh_long(
                    *a0, rs, ra, lo, hi, g=g, rows=rows, znorm=True),
                    fused_gather_lb_keogh(*a0, rs, ra, lo, hi, g=g,
                                          rows=rows, znorm=True)):
                check_equal(torch, "fused_gather_lb_keogh long-row vs "
                            "staged kernel", x, y)
        del coll, a0
    n_env, w = 20_000, 6_000
    lo = torch.randn((n_env, w), device=dev)
    hi = lo + torch.rand((n_env, w), device=dev)
    lo[:7, 0], hi[:7, 0] = -float("inf"), float("inf")
    valid = torch.rand(n_env, device=dev) > 0.01
    bp = torch.sort(torch.randn(255, device=dev)).values
    sym_lo = torch.searchsorted(bp, lo, right=True).to(torch.int32)
    sym_hi = torch.searchsorted(bp, hi, right=True).to(torch.int32)
    qp = torch.randn((BATCH, w), device=dev)
    qh = qp + torch.rand((BATCH, w), device=dev)
    for nseg in (LQ_ED // LQ["seg_len"], w):
        errs["mindist_sym"] = max(errs["mindist_sym"], check_close(
            torch, "mindist_sym",
            mindist_sym(qp, qh, sym_lo, sym_hi, bp, valid, 16, nseg),
            ref.mindist_sym_ref(qp, qh, sym_lo, sym_hi, bp, valid, 16,
                                nseg)))
        errs["mindist_paa"] = max(errs["mindist_paa"], check_close(
            torch, "mindist_paa",
            mindist_paa(qp, qh, lo, hi, valid, 16, nseg),
            ref.mindist_ref(qp, qh, lo, hi, valid, 16, nseg)))
    del lo, hi, sym_lo, sym_hi
    for s_, n, lmin, lmax, seg in ((2, 14_100, 1_000, 14_000, 64),
                                   (3, 30_100, 29_000, 30_000, 16)):
        x = torch.from_numpy(np.cumsum(rng.normal(size=(s_, n)), -1).astype(
            np.float32)).to(dev)
        xc = x - x.mean(dim=-1, keepdim=True)
        sums = (_prefix(xc), _prefix(xc * xc))
        kw = dict(lmin=lmin, lmax=lmax, gamma=g - 1, seg_len=seg)
        for k_, c_ in zip(envelope_znorm(*sums, **kw),
                          ref.envelope_znorm_ref(*sums, **kw)):
            check_equal(torch, f"envelope_znorm past its staging ({lmin}, "
                        f"{lmax})", k_, c_)
    return errs


def brute64_ed(torch, data, qs, k: int, znorm: bool):
    """Exact ED k-NN of equal-length queries on the card in float64: every
    window's distance by the dot identity over float64 window sums (as
    `brute64_ed_within`), the window dots of all queries as one product a
    block of series, each block's k best kept on the card.  Returns
    [(series, offsets, dists)] a query, numpy, nearest first."""
    qlen = len(qs[0])
    s, n = data.shape
    n_off = n - qlen + 1
    q = torch.from_numpy(np.stack(qs).astype(np.float64)).to(data.device)
    if znorm:
        q = (q - q.mean(1, keepdim=True)) / q.std(
            1, correction=0, keepdim=True).clamp_min(1e-8)
    qss, qsum = (q * q).sum(1), q.sum(1)
    block = max(1, BRUTE_ELEMS // (n_off * qlen))
    best_d = torch.full((len(qs), k), float("inf"), dtype=torch.float64,
                        device=data.device)
    best_i = torch.full((len(qs), k), -1, dtype=torch.int64,
                        device=data.device)
    for start in range(0, s, block):
        x = data[start:start + block].double()
        dot = x.unfold(1, qlen, 1).reshape(-1, qlen) @ q.T   # (W_b, nq)
        c1 = torch.nn.functional.pad(x.cumsum(1), (1, 0))
        c2 = torch.nn.functional.pad((x * x).cumsum(1), (1, 0))
        s1 = (c1[:, qlen:] - c1[:, :-qlen]).reshape(-1, 1)
        s2 = (c2[:, qlen:] - c2[:, :-qlen]).reshape(-1, 1)
        if znorm:
            mu = s1 / qlen
            var = (s2 / qlen - mu * mu).clamp_min(0.0)
            sd = var.sqrt().clamp_min(1e-8)
            d2 = qlen * var / (sd * sd) - 2 * (dot - mu * qsum) / sd + qss
        else:
            d2 = s2 - 2 * dot + qss
        v, i = torch.topk(d2, min(k, d2.shape[0]), dim=0, largest=False)
        cand_d = torch.cat([best_d, v.T], 1)
        cand_i = torch.cat([best_i, i.T + start * n_off], 1)
        order = torch.argsort(cand_d, dim=1, stable=True)[:, :k]
        best_d = cand_d.gather(1, order)
        best_i = cand_i.gather(1, order)
        del x, dot, c1, c2, d2
    idx = best_i.cpu().numpy()
    dist = best_d.clamp_min(0.0).sqrt().cpu().numpy()
    return [(i // n_off, i % n_off, d) for i, d in zip(idx, dist)]


def check_slice3_kernels(torch, dev, p, probe, rng):
    """The index build's and the host backend's kernels against their
    plain versions at the path's shapes; returns the max abs error of
    each."""
    from repro_torch.core import planner
    from repro_torch.core.envelope import _prefix
    from repro_torch.core.paa import znormalize
    from repro_torch.kernels import ref
    from repro_torch.kernels.batch_ed import batch_ed
    from repro_torch.kernels.envelope import (envelope_znorm,
                                              envelope_znorm_masters)
    from repro_torch.kernels.lb_keogh import lb_keogh
    errs = dict.fromkeys(("envelope_znorm", "batch_ed", "lb_keogh"), 0.0)
    # the build entry on the probe collection: kernel, plain version on
    # the card and on the CPU, from the same prefix sums
    x = probe.data
    xc = x - x.mean(dim=-1, keepdim=True)
    csum, csum2 = _prefix(xc), _prefix(xc * xc)
    kw = dict(lmin=p.lmin, lmax=p.lmax, gamma=p.gamma, seg_len=p.seg_len)
    got = envelope_znorm(csum, csum2, **kw)
    card = ref.envelope_znorm_ref(csum, csum2, **kw)
    cpu = ref.envelope_znorm_ref(csum.cpu(), csum2.cpu(), **kw)
    for k, c, h in zip(got, card, cpu):
        check_equal(torch, "envelope_znorm", k, c)
        check_equal(torch, "envelope_znorm (plain on the CPU)", k, h)
    # the per-master entry on every master of the first series
    n = x.shape[1]
    offs = torch.arange(n - p.lmin + 1, device=dev)
    start = offs[:, None] + torch.arange(p.w, device=dev) * p.seg_len
    segmean = ref.true_div(csum[0, (start + p.seg_len).clamp(max=n)]
                           - csum[0, start.clamp(max=n)], p.seg_len)
    ends = (offs[:, None] + torch.arange(p.lmin, p.lmax + 1, device=dev)
            ).clamp(max=n)
    margs = (segmean.contiguous(),
             (csum[0, ends] - csum[0, offs][:, None]).contiguous(),
             (csum2[0, ends] - csum2[0, offs][:, None]).contiguous(),
             offs.to(torch.int32))
    mkw = dict(n=n, lmin=p.lmin, seg_len=p.seg_len)
    for k, c in zip(envelope_znorm_masters(*margs, **mkw),
                    ref.envelope_scan_ref(*margs, **mkw)):
        check_equal(torch, "envelope_znorm_masters", k, c)
    # batch_ed and lb_keogh on one host chunk's worth of windows
    for qlen, r in DTW_CASES:
        windows = probe_windows(torch, probe, rng, qlen)
        q = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
            np.float32)).to(dev)
        qn, dlo, dhi, _, _ = planner.prepare_query_batch(q, p.seg_len, True,
                                                         "dtw", r)
        for qb in (1, 8):
            for znorm, qs in ((True, qn[:qb]), (False, q[:qb])):
                errs["batch_ed"] = max(errs["batch_ed"], check_close(
                    torch, "batch_ed", batch_ed(windows, qs, znorm),
                    ref.batch_ed_ref(windows, qs, znorm)))
        wn = znormalize(windows)
        errs["lb_keogh"] = max(errs["lb_keogh"], check_close(
            torch, "lb_keogh", lb_keogh(dlo[0], dhi[0], wn),
            ref.lb_keogh_ref(dlo[0], dhi[0], wn)))
    return errs


def check_lower_bounds(torch, index, data, p, queries, n_sample: int, seed):
    """On a sample of the index's valid envelopes, every lower bound
    (iSAX and PAA) of every query is at most the true distance of the
    envelope's nearest candidate window (float64 on the card; slack 1e-4
    for the float32 bound).  Returns the largest lb - d seen."""
    from repro_torch.core import planner
    env = index.envelopes
    dev = data.device
    s, n = data.shape
    g = p.gamma + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.nonzero(env.valid).squeeze(1)
    pick = valid[torch.randint(len(valid), (n_sample,), generator=gen,
                               device=dev)]
    sub = env.map(lambda t: t[pick].contiguous())
    sid, anc = sub.series_id.long(), sub.anchor.long()
    worst = -float("inf")
    for q in queries:
        qlen = len(q)
        qt = torch.from_numpy(np.asarray(q, np.float32)).to(dev)[None]
        qn, _, _, qb, qh = planner.prepare_query_batch(qt, p.seg_len,
                                                       p.znorm)
        offs = anc[:, None] + torch.arange(g, device=dev)
        ok = ((torch.arange(g, device=dev) < sub.n_master[:, None])
              & (offs + qlen <= n))
        w = data.unfold(1, qlen, 1)[sid[:, None], offs.clamp(max=n - qlen)
                                    ].double()
        if p.znorm:
            w = (w - w.mean(-1, keepdim=True)) / w.std(
                -1, keepdim=True, correction=0).clamp_min(1e-8)
        d = torch.sqrt(((w - qn[0].double()) ** 2).sum(-1))
        d_min = torch.where(ok, d, float("inf")).amin(dim=1)
        for use_paa in (False, True):
            lb = planner.env_lower_bounds_batch(
                qb, qh, sub, index.breakpoints, p.seg_len,
                p.query_segments(qlen), use_paa)[0].double()
            excess = float((lb - d_min).max())
            worst = max(worst, excess)
            if excess > 1e-4:
                raise AssertionError(
                    f"a lower bound exceeds the true distance by {excess} "
                    f"(qlen {qlen}, use_paa {use_paa})")
    return worst


def brute64_ed_within(torch, data, q, znorm: bool, radius: float):
    """Every window of q's length within `radius` of q under ED, in
    float64 on the card, by the dot identity over float64 window sums
    (its cancellation is ~1e-12 at these sizes), in blocks of series.
    Returns (flat index series * n_off + offset, distance), numpy."""
    qlen = len(q)
    s, n = data.shape
    n_off = n - qlen + 1
    qt = torch.from_numpy(np.asarray(q, np.float64)).to(data.device)
    if znorm:
        qt = (qt - qt.mean()) / qt.std(correction=0).clamp_min(1e-8)
    qss, qsum = float((qt * qt).sum()), float(qt.sum())
    block = max(1, BRUTE_ELEMS // (n_off * qlen))
    out_i, out_d = [], []
    for start in range(0, s, block):
        x = data[start:start + block].double()
        dot = torch.matmul(x.unfold(1, qlen, 1), qt)     # (S_b, n_off)
        c1 = torch.nn.functional.pad(x.cumsum(1), (1, 0))
        c2 = torch.nn.functional.pad((x * x).cumsum(1), (1, 0))
        s1 = c1[:, qlen:] - c1[:, :-qlen]
        s2 = c2[:, qlen:] - c2[:, :-qlen]
        if znorm:
            mu = s1 / qlen
            var = (s2 / qlen - mu * mu).clamp_min(0.0)
            sd = var.sqrt().clamp_min(1e-8)
            d2 = qlen * var / (sd * sd) - 2 * (dot - mu * qsum) / sd + qss
        else:
            d2 = s2 - 2 * dot + qss
        hit = torch.nonzero(d2 <= radius ** 2)
        out_i.append(hit[:, 0] * n_off + hit[:, 1] + start * n_off)
        out_d.append(d2[hit[:, 0], hit[:, 1]].clamp_min(0.0).sqrt())
        del x, dot, c1, c2
    return torch.cat(out_i).cpu().numpy(), torch.cat(out_d).cpu().numpy()


def ed_band(qlen: int, eps: float, xmax: float = 0.0) -> float:
    """The band around eps in which an ED window's membership may differ
    from the float64 brute force: RANGE_BAND, or where larger the
    float32 dot identity's error at this length (the kernels sum the dot
    in float32 over qlen terms: ~2 qlen sqrt(qlen) ulps of d2, measured
    up to ~0.2 of d2 at qlen 29,000), or, given the series' largest
    magnitude xmax, the dot's rounding on raw values that large (~qlen
    xmax ulps of the dot, doubled in d2 and again by 1 / sd)."""
    return max(RANGE_BAND, 2.0 * qlen ** 1.5 * 2.0 ** -24 / max(eps, 1e-6),
               4.0 * qlen * xmax * 2.0 ** -24 / max(eps, 1e-6))


def range_set_check(res, idx, d, eps: float, n_off: int, what: str,
                    band: float = RANGE_BAND):
    """Raise unless a range answer's (series, offset) hits, without
    duplicates, equal the float64 brute force's {d <= eps}, except
    windows whose float64 d lies within `band` of eps (either way), and
    its distances are the float64 ones within RANGE_BAND; idx/d: the
    brute force's windows with d <= eps + band at least.  Returns (hits,
    boundary windows)."""
    got = (res.series.astype(np.int64) * n_off + res.offsets).tolist()
    if len(set(got)) != len(got):
        raise AssertionError(f"{what}: duplicate hits")
    got = set(got)
    sure = set(idx[d <= eps - band].tolist())
    maybe = set(idx[d <= eps + band].tolist())
    if not sure <= got <= maybe:
        raise AssertionError(
            f"{what}: {len(sure - got)} hits missing, {len(got - maybe)} "
            f"extra against the float64 brute force (eps {eps})")
    d64 = dict(zip(idx.tolist(), d.tolist()))
    flat = res.series.astype(np.int64) * n_off + res.offsets
    err = max((abs(float(x) - d64[int(i)]) for i, x in zip(flat, res.dists)),
              default=0.0)
    if err > RANGE_BAND:
        raise AssertionError(f"{what}: distances off the float64 brute "
                             f"force by {err}")
    return len(got), len(maybe) - len(sure)


def trace_range_scan(torch, coll, index, p, queries, spec):
    """The range scan of one batch alone under torch.profiler: the range
    pack is made first, and the trace holds only the chunk loop and its
    readback.  Returns its chunk steps, kernel launch calls and device
    activities a step, busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import executor, planner
    from repro_torch.kernels.fused_verify import (fused_gather_ed_range,
                                                  fused_gather_lb_keogh_range)
    dev = coll.data.device
    env = index.envelopes
    b, qlen = len(queries), len(queries[0])
    q = torch.from_numpy(np.stack(queries)).to(dev)
    qs, dlo, dhi, qb, qh = planner.prepare_query_batch(
        q, p.seg_len, p.znorm, spec.measure, spec.r)
    lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                         p.seg_len, p.query_segments(qlen),
                                         False)
    eps2 = torch.full((b,), float(spec.eps) ** 2, device=dev)
    plan = planner.device_range_pack(env.series_id, env.anchor, env.n_master,
                                     lbs, eps2,
                                     n_pad=executor.pow2ceil(env.size))[:4]
    entry = (fused_gather_ed_range if spec.measure == "ed"
             else fused_gather_lb_keogh_range)
    entry.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = executor.device_range_scan(
            coll, *plan, qs, dlo, dhi, eps2, capacity=spec.range_capacity,
            g=p.gamma + 1, measure=spec.measure, r=spec.r, znorm=p.znorm,
            chunk_size=spec.chunk_size)
        out[3].cpu()
        wall = time.perf_counter() - t0
    steps = entry.launches
    events = device_events(prof)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith(("cudaLaunchKernel",
                                        "cuLaunchKernel")))
    busy = device_ms(prof) / 1e3
    return {"qlen": qlen, "measure": spec.measure, "chunk_steps": steps,
            "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall, "launch_calls": launches,
            "device_events": len(events),
            "launch_calls_per_step": launches / max(steps, 1),
            "device_events_per_step": len(events) / max(steps, 1)}


def dtw64_windows(torch, data, q, series, offsets, r: int, znorm: bool):
    """The float64 DTW distance of q to each (series, offset) window (the
    plain DP, Z-normalized where the index is), numpy."""
    return dtw64_many(torch, data, [(q, series, offsets)], r, znorm)[0]


def dtw64_many(torch, data, jobs, r: int, znorm: bool):
    """`dtw64_windows` of several (q, series, offsets) jobs of one query
    length in ONE DP over every window (a query a candidate: the plain
    DP's row loop runs once), a numpy array a job."""
    from repro_torch.core import dtw
    sizes = [len(s_) for _, s_, _ in jobs]
    if sum(sizes) == 0:
        return [np.zeros(0) for _ in jobs]
    qlen = len(jobs[0][0])
    w = torch.stack([data[s_, o:o + qlen] for _, ser, offs in jobs
                     for s_, o in zip(ser, offs)]).double()
    qt = torch.from_numpy(np.stack([np.asarray(q, np.float64)
                                    for (q, _, _), m in zip(jobs, sizes)
                                    for _ in range(m)])).to(data.device)
    if znorm:
        w = (w - w.mean(-1, keepdim=True)) / w.std(
            -1, keepdim=True, correction=0).clamp_min(1e-8)
        qt = (qt - qt.mean(-1, keepdim=True)) / qt.std(
            -1, keepdim=True, correction=0).clamp_min(1e-8)
    d = torch.sqrt(dtw.dtw_band(qt, w, r, squared=True)).cpu().numpy()
    return np.split(d, np.cumsum(sizes)[:-1])


def same_answers(a, b, atol: float, what: str) -> float:
    """Raise unless results a and b hold the same (series, offset) set and
    their distances (each sorted) agree within atol; returns the max abs
    difference."""
    if set(zip(a.series.tolist(), a.offsets.tolist())) \
            != set(zip(b.series.tolist(), b.offsets.tolist())):
        raise AssertionError(f"{what}: answers differ: "
                             f"{list(zip(a.series, a.offsets))} vs "
                             f"{list(zip(b.series, b.offsets))}")
    err = float(np.abs(np.sort(a.dists) - np.sort(b.dists)).max())
    if err > atol:
        raise AssertionError(f"{what}: distances {a.dists} vs {b.dists}")
    return err


def range_phase(torch, engine, p, range_cases, dtw_oracle, timings,
                zero_counts, read_counts):
    """[16], eps-range on `engine`'s index: for each (measure, qlen, r,
    queries) of `range_cases` (a batch), eps is the median of the
    queries' RANGE_K-th nearest distances from one exact device k-NN
    call; the device backend runs at both RANGE_CAPS (the small one
    overflows and finishes on the host, at RANGE_SMALL_CHUNK; DTW: only
    the queries `dtw_oracle` holds), counters set to 0 just before and
    read just after each; RANGE_HOST queries a measure on the host
    backend; every hit set held to the float64 brute force (ED: every
    query; DTW: the nearest windows `dtw_oracle` kept by (qlen, query));
    then the range entries and range_append are held to their plain
    versions on the batch's pack and timed into `timings`, and the range
    scan alone traced per measure at the last length.  Returns (the
    cases' records, each range kernel's launches over the large
    capacity's runs, the traces, and the answers: (measure, qlen) ->
    capacity -> {query: SearchResult})."""
    from repro_torch.core import QuerySpec, executor, planner
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import dtw_survivors
    from repro_torch.kernels.fused_verify import (fused_gather_ed,
                                                  fused_gather_ed_range,
                                                  fused_gather_lb_keogh_range)
    from repro_torch.kernels.range_append import range_append
    index = engine.index
    coll, env = index.collection, index.envelopes
    dev = coll.data.device
    g = p.gamma + 1
    range_kernels = {"ed": ("fused_gather_ed_range", "range_append",
                            "mindist_sym"),
                     "dtw": ("fused_gather_lb_keogh_range", "dtw_survivors",
                             "range_append", "mindist_sym")}
    knn_kernels = ("fused_gather_ed_chunk", "fused_gather_lb_keogh_chunk",
                   "pool_merge", "pool_merge_partials", "mindist_paa")
    big_cap = max(RANGE_CAPS)
    range_launches, range_answers = {}, {}
    cases = []
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    n_pad = executor.pow2ceil(env.size)
    for measure, qlen, r, qs in range_cases:
        n_off = coll.data.shape[1] - qlen + 1
        bq = len(qs)
        t0 = time.perf_counter()
        knn64 = engine.search(qs, QuerySpec(k=RANGE_K, measure=measure, r=r))
        eps = float(np.median([a.dists[-1] for a in knn64]))
        knn_s = time.perf_counter() - t0
        if measure == "ed":
            checked_q = list(range(len(qs)))
            oracle = {j: brute64_ed_within(torch, coll.data, qs[j], p.znorm,
                                           eps + RANGE_BAND)
                      for j in checked_q}
        else:
            checked_q = list(range(DTW_BRUTE[qlen]))
            oracle = {j: dtw_oracle[(qlen, j)] for j in checked_q}
            if any(d[-1] <= eps + RANGE_BAND for _, d in oracle.values()):
                raise AssertionError(f"[8]'s {DTW_KEEP} nearest windows do "
                                     f"not reach eps {eps} (qlen {qlen})")
        brute_s = time.perf_counter() - t0 - knn_s
        case = {"measure": measure, "qlen": qlen, "r": r, "eps": eps,
                "knn_s": knn_s, "brute_s": brute_s, "runs": {}}
        cases.append(case)
        answers_r = range_answers[(measure, qlen)] = {}
        for cap in RANGE_CAPS:
            small = cap < big_cap
            sub = (checked_q if small and measure == "dtw"
                   else list(range(len(qs))))
            spec = QuerySpec(eps=eps, measure=measure, r=r,
                             range_capacity=cap,
                             chunk_size=RANGE_SMALL_CHUNK if small else 512)
            zero_counts()
            executor.device_range_scan.syncs = 0
            tb = time.perf_counter()
            res = engine.search([qs[j] for j in sub], spec)
            wall = time.perf_counter() - tb
            counts = read_counts(range_kernels[measure] + knn_kernels)
            for name in range_kernels[measure]:
                if counts[name] <= 0:
                    raise AssertionError(f"{name} was not launched on the "
                                         f"{measure} range path")
            for name in knn_kernels:
                if counts[name]:
                    raise AssertionError(f"the {measure} range path "
                                         f"launched {name}")
            if not small:
                for name, n_ in counts.items():
                    range_launches[name] = range_launches.get(name, 0) + n_
            answers_r[cap] = dict(zip(sub, res))
            case["runs"][cap] = {
                "queries": len(sub), "chunk_size": spec.chunk_size,
                "wall_s": wall, "queries_per_s": len(sub) / wall,
                "launches": counts,
                "scan_syncs": executor.device_range_scan.syncs,
                "host_syncs": executor.to_host.syncs,
                "mean_chunks_visited": float(np.mean(
                    [x.stats.chunks_visited for x in res])),
                "mean_envelopes_checked": float(np.mean(
                    [x.stats.envelopes_checked for x in res])),
                "mean_true_dists": float(np.mean(
                    [x.stats.true_dist_computations for x in res])),
                "overflows": sum(x.stats.range_overflows for x in res)}
        # every checked query equals the float64 brute force at both
        # capacities; the two capacities give the same hits (identical
        # sets: the overflow tail's host kernels round otherwise, so a
        # window may differ only where its float64 distance lies within
        # RANGE_BAND of eps); each capacity overflows exactly the queries
        # with more hits than it holds
        full = answers_r[big_cap]
        hits = [len(full[j].dists) for j in sorted(full)]
        edge, cap_differ = 0, 0
        for cap, ans in answers_r.items():
            run = case["runs"][cap]
            want_over = sum(len(x.dists) > cap for x in ans.values())
            if run["overflows"] != want_over:
                raise AssertionError(
                    f"{measure} range at capacity {cap}: {run['overflows']} "
                    f"overflows, {want_over} queries hold more hits")
            for j, res in ans.items():
                if j in oracle:
                    edge += range_set_check(
                        res, *oracle[j], eps, n_off,
                        f"{measure} range qlen {qlen} capacity {cap}")[1]
                a_ = set(zip(res.series.tolist(), res.offsets.tolist()))
                b_ = set(zip(full[j].series.tolist(),
                             full[j].offsets.tolist()))
                if a_ != b_:
                    cap_differ += len(a_ ^ b_)
                    if j not in oracle:
                        raise AssertionError(f"{measure} range: capacities "
                                             f"{cap} and {big_cap} differ")
        hspec = QuerySpec(eps=eps, measure=measure, r=r, scan_backend="host",
                          chunk_size=RANGE_SMALL_CHUNK)
        zero_counts()
        tb = time.perf_counter()
        host_res = [engine.search(qs[j], hspec)
                    for j in range(RANGE_HOST // 2)]
        host_wall = time.perf_counter() - tb
        host_syncs = executor.to_host.syncs
        host_exact = 0
        for j, hres in enumerate(host_res):
            range_set_check(hres, *oracle[j], eps, n_off,
                            f"host {measure} range qlen {qlen}")
            host_exact += set(zip(hres.series.tolist(),
                                  hres.offsets.tolist())) == set(
                zip(full[j].series.tolist(), full[j].offsets.tolist()))
        case.update(hits_min=min(hits), hits_median=float(np.median(hits)),
                    hits_max=max(hits), boundary_windows=edge,
                    capacities_differ_at=cap_differ,
                    host={"queries": len(host_res), "wall_s": host_wall,
                          "host_syncs": host_syncs,
                          "same_set_as_device": host_exact})
        rb = case["runs"][big_cap]
        rs = case["runs"][min(RANGE_CAPS)]
        log(f"[16] {measure} range qlen {qlen}: eps {eps:.4f} (median "
            f"{RANGE_K}th neighbour, {knn_s:.2f} s), hits a query "
            f"{min(hits)}-{max(hits)} (median {np.median(hits):.0f}); "
            f"capacity {big_cap}: {rb['queries_per_s']:.2f} queries/s, "
            f"batch {rb['wall_s']:.3f} s, {rb['scan_syncs']} stop-test "
            f"syncs + 1 readback, mean chunks "
            f"{rb['mean_chunks_visited']:.1f}, overflows {rb['overflows']};"
            f" capacity {min(RANGE_CAPS)} ({rs['queries']} queries, chunk "
            f"{RANGE_SMALL_CHUNK}): {rs['wall_s']:.2f} s, overflows "
            f"{rs['overflows']}, host syncs {rs['host_syncs']}; launches "
            f"{rb['launches']}; = the float64 brute force on "
            f"{len(checked_q)} queries ({edge} windows within {RANGE_BAND} "
            f"of eps; {brute_s:.1f} s); capacities differ at {cap_differ} "
            f"windows; host backend {len(host_res)} "
            f"queries in {host_wall:.2f} s, {host_syncs} syncs, same set "
            f"{host_exact}/{len(host_res)}")

        # the range entries and range_append on this batch's pack: held to
        # their plain versions, then timed (its first 8 chunks)
        q = torch.from_numpy(np.stack(qs)).to(dev)
        qn_, dlo_, dhi_, qb_, qh_ = planner.prepare_query_batch(
            q, p.seg_len, p.znorm, measure, r)
        lbs_ = planner.env_lower_bounds_batch(
            qb_, qh_, env, index.breakpoints, p.seg_len,
            p.query_segments(qlen), False)
        eps2_t = torch.full((bq,), eps * eps, device=dev)
        rplan = planner.device_range_pack(env.series_id, env.anchor,
                                          env.n_master, lbs_, eps2_t,
                                          n_pad=n_pad)[:4]
        rows = 512
        n_t = min(8, n_pad // rows)         # the chunks timed
        ovf_t = torch.full((bq,), n_pad // rows, dtype=torch.int32,
                           device=dev)
        if measure == "ed":
            # the mask and counters bit for bit, d2 bit for bit against
            # the mask over the contract entry's d2 and within the ED
            # tolerance against the plain version's
            st_k = torch.zeros((bq, 6), dtype=torch.int32, device=dev)
            st_p = torch.zeros_like(st_k)
            range_err = 0.0
            for i in range(min(3, n_t)):
                cols = slice(i * rows, (i + 1) * rows)
                dist = fused_gather_ed(
                    *a0, rplan[0][:, cols].reshape(-1).contiguous(),
                    rplan[1][:, cols].reshape(-1).contiguous(), qn_, g=g,
                    rows=rows, znorm=p.znorm)
                got = fused_gather_ed_range(
                    *a0, *rplan, qn_, eps2_t, ovf_t, st_k, i=i, chunk=rows,
                    g=g, znorm=p.znorm)
                check_equal(torch, "fused_gather_ed_range vs contract", got,
                            ref.fused_gather_ed_range_ref(
                                *a0, *rplan, qn_, eps2_t, ovf_t,
                                st_p.clone(), i=i, chunk=rows, g=g,
                                znorm=p.znorm, dist=dist))
                range_err = max(range_err, check_close(
                    torch, "fused_gather_ed", got,
                    ref.fused_gather_ed_range_ref(
                        *a0, *rplan, qn_, eps2_t, ovf_t, st_p, i=i,
                        chunk=rows, g=g, znorm=p.znorm)))
                check_equal(torch, "fused_gather_ed_range counters", st_k,
                            st_p)
            call = [lambda i=i: fused_gather_ed_range(
                *a0, *rplan, qn_, eps2_t, ovf_t, st_k, i=i, chunk=rows, g=g,
                znorm=p.znorm) for i in range(n_t)]
            plain = [lambda i=i: ref.fused_gather_ed_range_ref(
                *a0, *rplan, qn_, eps2_t, ovf_t, st_p, i=i, chunk=rows, g=g,
                znorm=p.znorm) for i in range(n_t)]
            nbytes, ops, n_ok = range_chunk_work(torch, coll, rplan, eps2_t,
                                                 qlen, rows, g, n_t)
            timings[("fused_gather_ed_range", qlen, rows)] = timing(
                torch, call, plain, nbytes, ops, range_err,
                f"B={bq} rows={rows} qlen={qlen} ok/call={n_ok:.0f}")
            d2_rows = [c() for c in call]
        else:
            steps = [chunk_args(torch, a0, qn_, dlo_, dhi_, rplan, i, rows,
                                eps2_t, g, ovf=ovf_t, znorm=p.znorm)
                     for i in range(n_t)]
            err, _ = check_chunk_entry(torch, *steps[0][:4], range_mode=True)
            call = [lambda c=c: fused_gather_lb_keogh_range(
                *c[0], c[3], **c[1]) for c in steps]
            plain = [lambda c=c: ref.fused_gather_lb_keogh_range_ref(
                *c[0], c[3].clone(), **c[1]) for c in steps]
            per_call = sum(int(c[2][4].sum()) for c in steps) / len(steps)
            nbytes, ops, n_ok = lb_chunk_work(torch, coll, rplan, eps2_t,
                                              qlen, rows, g, n_t, per_call,
                                              ovf=ovf_t)
            timings[("fused_gather_lb_keogh_range", qlen, rows)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={bq} rows={rows} qlen={qlen} g={g} ok/call={n_ok:.0f} "
                f"surv/call={per_call:.0f}", events=2)
            d2_rows = [dtw_survivors(*c[4][:-1], c[4][-1].clone(), r=r,
                                     znorm=p.znorm) for c in steps]
        # range_append over the 8 steps' distance rows into a buffer that
        # cannot overflow while timed: bit for bit, then timed
        cap_t = 1 << 16

        def fresh_buffer():
            return ([torch.full((bq, cap_t), float("inf"), device=dev),
                     torch.full((bq, cap_t), -1, dtype=torch.int32,
                                device=dev),
                     torch.full((bq, cap_t), -1, dtype=torch.int32,
                                device=dev)],
                    torch.zeros(bq, dtype=torch.int32, device=dev),
                    torch.full((bq,), n_pad // rows, dtype=torch.int32,
                               device=dev))
        bk, bp = fresh_buffer(), fresh_buffer()
        for i, d2r in enumerate(d2_rows):
            range_append(d2r, rplan[0], rplan[1], eps2_t, *bk, i=i,
                         chunk=rows, g=g)
            ref.range_append_ref(d2r, rplan[0], rplan[1], eps2_t, *bp, i=i,
                                 chunk=rows, g=g)
        for name, x, y in zip(("d2", "sid", "off", "cnt", "ovf"),
                              [*bk[0], bk[1], bk[2]], [*bp[0], bp[1], bp[2]]):
            check_equal(torch, f"range_append {name}", x, y)
        step_hits = sum(int((torch.isfinite(d) & (d <= eps2_t[:, None]))
                            .sum()) for d in d2_rows) / len(d2_rows)
        call = [lambda i=i, d=d: range_append(
            d, rplan[0], rplan[1], eps2_t, *bk, i=i, chunk=rows, g=g)
            for i, d in enumerate(d2_rows)]
        plain = [lambda i=i, d=d: ref.range_append_ref(
            d, rplan[0], rplan[1], eps2_t, *bp, i=i, chunk=rows, g=g)
            for i, d in enumerate(d2_rows)]
        timings[("range_append", measure, qlen)] = timing(
            torch, call, plain, bq * rows * g * 4 + step_hits * 20
            + 4 * bq * 4, 0, 0.0,
            f"B={bq} M={rows * g} cap={cap_t} hits/call={step_hits:.1f}")
        del d2_rows, call, plain, bk, bp
    # the range scan alone, traced, per measure at qlen 256: at most 3
    # kernel launch calls an ED step and 4 a DTW step
    traced = {}
    for case, (measure, qlen, r, qs) in zip(cases, range_cases):
        if qlen != QLENS[-1]:
            continue
        tr = trace_range_scan(torch, coll, index, p, qs, QuerySpec(
            eps=case["eps"], measure=measure, r=r))
        traced[measure] = tr
        log(f"[16] the {measure} range scan alone (qlen {qlen}): "
            f"{tr['chunk_steps']} chunk steps, "
            f"{tr['launch_calls_per_step']:.2f} kernel launch calls and "
            f"{tr['device_events_per_step']:.2f} device activities a step, "
            f"device busy {tr['device_busy_s']:.4f} s of {tr['wall_s']:.4f} s"
            f" (idle share {tr['device_idle_share']:.3f})")
        limit = 3 if measure == "ed" else 4
        if tr["launch_calls_per_step"] > limit:
            raise AssertionError(f"the {measure} range scan makes more than "
                                 f"{limit} kernel launch calls a chunk step")
    for key, t in timings.items():
        if key[0] in ("fused_gather_ed_range", "fused_gather_lb_keogh_range",
                      "range_append"):
            log(f"[16] {key[0]:27s} {t['shape']:45s} kernel {t['ms']:.4f} "
                f"ms  plain {t['plain_ms']:.4f} ms  bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}, {t['timer']}/"
                f"{t['plain_timer']}; events {t['event_ms']:.4f} / "
                f"{t['plain_event_ms']:.4f} ms)")
    return cases, range_launches, traced, range_answers



def same_results(got, want, what: str, stats: bool = True) -> None:
    """Raise unless two lists of results hold the same distances (bit for
    bit), (series, offset) rows and, when `stats`, SearchStats."""
    for a, b in zip(got, want, strict=True):
        if not (np.array_equal(a.dists, b.dists)
                and np.array_equal(a.series, b.series)
                and np.array_equal(a.offsets, b.offsets)):
            raise AssertionError(f"{what}: answers differ")
        if stats and a.stats != b.stats:
            raise AssertionError(f"{what}: SearchStats differ: {a.stats} vs "
                                 f"{b.stats}")


def window_batch(rng, data, sids, qlen: int, noise: float = 0.1):
    """Windows of the given series plus N(0, noise) noise: (queries, their
    (series, offset))."""
    offs = rng.integers(0, data.shape[1] - qlen + 1, len(sids))
    return ([data[s, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
             * noise for s, o in zip(sids, offs)], list(zip(sids, offs)))


def storage_phase(torch, engine, data, p, batches, answers, dtw_batches,
                  dtw_specs, dtw_answers, range_eps, zero_counts, read_counts,
                  seed: int):
    """[17], storage and ingestion: (a) save [3]'s index and open it cold
    (every stored array equal to the index in memory, the payload still
    unread; one [4] ED and one [8] DTW batch equal their answers and
    SearchStats); (b) append APPEND_SERIES new series to the opened
    engine (the delta's envelopes from envelope_znorm), search batches
    taken from them (ED and DTW k-NN, ED range at [16]'s eps), compact
    (equal to build_index over every series on the card in every field
    and level) and search again (the same answers); (c) the paged scans
    over the first PAGED_SERIES series of [3]'s data opened under a
    budget of half the payload, held bit for bit (answers and SearchStats) to the
    same index opened resident: ED and DTW k-NN, ED range, and ED range
    at capacity 16 (overflow, host continuation through the page cache),
    with the page cache's counters, the prefetch waits and launch calls
    a step.  Returns (the records, (the appended part, the batch of its
    windows, the opened engine's ED / DTW / range answers to it before
    the compact)) — [20] holds the sharded engine to those answers."""
    import os
    import shutil
    import tempfile
    from repro_torch.core import (Collection, QuerySpec, UlisseEngine,
                                  build_index)
    from repro_torch.core import executor
    from repro_torch.storage import open_index
    from repro_torch.storage import format as fmt
    from repro_torch.train.data import series_batches
    dev = engine.device
    out = {}
    root = tempfile.mkdtemp(prefix="ulisse_smoke_")
    try:
        # -- (a) save and open ------------------------------------------
        path = os.path.join(root, "idx")
        t0 = time.perf_counter()
        engine.save(path)
        save_s = time.perf_counter() - t0
        manifest = fmt.read_manifest(path)
        disk = {rel: int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize
                for rel, e in manifest["arrays"].items()}
        payload = sum(int(np.prod(e["shape"])) * 4
                      for e in manifest["collection_shards"])
        t0 = time.perf_counter()
        opened = UlisseEngine.open(path, device=dev)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        store = opened.index.collection
        if store.is_materialized:
            raise AssertionError("the cold open read the raw payload")
        want_dtypes = {"paa_lo": "float32", "paa_hi": "float32",
                       "sym_lo": "int32", "sym_hi": "int32",
                       "series_id": "int32", "anchor": "int32",
                       "n_master": "int32", "valid": "bool"}
        for rel, e in manifest["arrays"].items():
            field = rel.split("/")[-1].split("_", 1)[-1] \
                if rel.startswith("levels/") else rel.split("/")[-1]
            if e["dtype"] != want_dtypes.get(field, "float32"):
                raise AssertionError(f"{rel} stored as {e['dtype']}")
        a, b = opened.index, engine.index
        pairs = [(getattr(a.envelopes, f), getattr(b.envelopes, f))
                 for f in want_dtypes]
        pairs += [(getattr(la, f), getattr(lb, f))
                  for la, lb in zip(a.levels, b.levels, strict=True)
                  for f in ("paa_lo", "paa_hi", "valid")]
        pairs.append((a.breakpoints, b.breakpoints))
        for x, y in pairs:
            if not torch.equal(x, y):
                raise AssertionError("an opened index array differs from "
                                     "the index in memory")
        for lo in range(0, data.shape[0], 1 << 16):
            hi = min(lo + (1 << 16), data.shape[0])
            if not np.array_equal(store.read_rows(lo, hi), data[lo:hi]):
                raise AssertionError(f"stored rows [{lo}, {hi}) differ")
        if store.is_materialized:
            raise AssertionError("reading the shards materialized the store")
        zero_counts()
        t0 = time.perf_counter()
        got_ed = opened.search(batches[0], QuerySpec(k=K))
        first_s = time.perf_counter() - t0
        got_dtw = opened.search(dtw_batches[0], dtw_specs[0])
        same_results(got_ed, answers[0], "[17] opened engine, ED batch")
        same_results(got_dtw, dtw_answers[0], "[17] opened engine, DTW batch")
        out["save_open"] = {
            "save_s": save_s, "open_s": open_s,
            "index_bytes_read": sum(disk.values()),
            "payload_bytes_on_disk": payload,
            "first_search_s": first_s,
            "launches": read_counts(("fused_gather_ed_chunk",
                                     "fused_gather_lb_keogh_chunk"))}
        log(f"[17] saved [3]'s index in {save_s:.2f} s; opened cold in "
            f"{open_s:.3f} s reading {sum(disk.values()) / 2 ** 20:.1f} MiB "
            f"of index (payload {payload / 2 ** 20:.1f} MiB left on disk); "
            f"every stored array equals the index in memory (the reference's "
            f"dtypes); the first ED batch (materializing the payload on the "
            f"card) {first_s:.2f} s; the opened engine's [4] ED and [8] DTW "
            f"batches equal their answers and SearchStats")

        # -- (b) ingestion -----------------------------------------------
        n0 = data.shape[0]
        new = series_batches(APPEND_SERIES, SERIES_LEN, seed=seed + 17)
        zero_counts()
        t0 = time.perf_counter()
        opened.append(new)
        torch.cuda.synchronize()
        append_s = time.perf_counter() - t0
        env_launches = read_counts(("envelope_znorm",))["envelope_znorm"]
        if env_launches <= 0:
            raise AssertionError("append did not launch envelope_znorm")
        want_delta = APPEND_SERIES * p.num_envelopes(SERIES_LEN)
        if opened.delta_size != want_delta:
            raise AssertionError(f"delta_size {opened.delta_size}, expected "
                                 f"{want_delta}")
        arng = np.random.default_rng(seed + 18)
        src = arng.choice(APPEND_SERIES, BATCH, replace=False)
        qs, truth = window_batch(arng, new, src, QLENS[0])
        specs = {"ed": QuerySpec(k=K), "dtw": dtw_specs[0],
                 "range": QuerySpec(eps=range_eps)}
        before = {name: opened.search(qs, spec)
                  for name, spec in specs.items()}
        appended = (new, qs, before)       # [20] is held to these
        for j, (s, o) in enumerate(truth):
            e, d, r = (before[x][j] for x in ("ed", "dtw", "range"))
            if (int(e.series[0]), int(e.offsets[0])) != (n0 + s, o):
                raise AssertionError(f"[17] appended window {s, o} not the "
                                     f"ED nearest: {e.series[0], e.offsets[0]}")
            if int(d.series[0]) != n0 + s:
                raise AssertionError(f"[17] appended series {s} not the DTW "
                                     f"nearest: {d.series[0]}")
            if (n0 + s, o) not in set(zip(r.series.tolist(),
                                          r.offsets.tolist())):
                raise AssertionError(f"[17] appended window {s, o} not in "
                                     f"its range answer")
        t0 = time.perf_counter()
        opened.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        rebuilt = build_index(opened.index.collection, p,
                              opened.index.breakpoints, block_size=64,
                              num_levels=2)
        a, b = opened.index, rebuilt
        for f in want_dtypes:
            if not torch.equal(getattr(a.envelopes, f),
                               getattr(b.envelopes, f)):
                raise AssertionError(f"compact() differs from build_index "
                                     f"in {f}")
        for la, lb in zip(a.levels, b.levels, strict=True):
            for f in ("paa_lo", "paa_hi", "valid"):
                if not torch.equal(getattr(la, f), getattr(lb, f)):
                    raise AssertionError(f"compact()'s levels differ from "
                                         f"build_index's in {f}")
        del rebuilt, a, b
        for name, spec in specs.items():
            same_results(opened.search(qs, spec), before[name],
                         f"[17] compacted engine, {name}", stats=False)
        out["ingest"] = {"series": APPEND_SERIES, "append_s": append_s,
                         "envelope_znorm_launches": env_launches,
                         "delta_size": want_delta, "compact_s": compact_s,
                         "envelopes": opened.index.num_envelopes,
                         "range_eps": range_eps}
        log(f"[17] appended {APPEND_SERIES} series in {append_s:.3f} s "
            f"(envelope_znorm x{env_launches}); delta_size {want_delta}; "
            f"ED and DTW k-NN and ED range (eps {range_eps:.4f}) find the "
            f"appended windows; compact() in {compact_s:.3f} s equals "
            f"build_index over {n0 + APPEND_SERIES} series on the card in "
            f"every field and level; the compacted engine's answers equal "
            f"the uncompacted engine's")
        del opened, store
        torch.cuda.empty_cache()

        # -- (c) the paged scans -----------------------------------------
        paged_series = min(PAGED_SERIES, len(data))
        pdata = data[:paged_series]
        ppath = os.path.join(root, "paged")
        UlisseEngine.from_collection(
            Collection.from_array(pdata, device=dev), p, block_size=64,
            num_levels=2, device=dev).save(ppath)
        budget = open_index(ppath, device=dev).collection.payload_bytes // 2
        res = UlisseEngine.open(ppath, device=dev)
        pag = UlisseEngine.open(ppath, device=dev, memory_budget_bytes=budget)
        prng = np.random.default_rng(seed + 19)
        pq = window_batch(prng, pdata, prng.choice(paged_series, BATCH,
                                                   replace=False),
                          QLENS[0])[0]
        runs = {"ed_knn": (pq, QuerySpec(k=K)),
                "dtw_knn": (pq, dtw_specs[0]),
                "ed_range": (pq, QuerySpec(eps=range_eps)),
                "ed_range_overflow": (pq[:2], QuerySpec(
                    eps=range_eps, range_capacity=16,
                    chunk_size=RANGE_SMALL_CHUNK))}
        names = ("fused_gather_ed_chunk", "pool_merge_partials",
                 "fused_gather_lb_keogh_chunk", "dtw_survivors", "pool_merge",
                 "fused_gather_ed_range", "range_append", "mindist_sym",
                 "mindist_paa")
        paged = {"series": paged_series, "budget_bytes": budget,
                 "payload_bytes": pag.index.collection.payload_bytes,
                 "runs": {}}
        for name, (qs, spec) in runs.items():
            want = res.search(qs, spec)
            st0 = pag.page_cache_stats()
            zero_counts()
            for key in executor.PAGED:
                executor.PAGED[key] = 0
            t0 = time.perf_counter()
            got = pag.search(qs, spec)
            wall = time.perf_counter() - t0
            counts = read_counts(names)
            st1 = pag.page_cache_stats()
            same_results(got, want, f"[17] paged {name}")
            rec = {"queries": len(qs), "wall_s": wall,
                   "queries_per_s": len(qs) / wall,
                   "chunk_steps": executor.PAGED["chunks"],
                   "stop_test_syncs": executor.PAGED["syncs"],
                   "prefetch_wait_s": executor.PAGED["prefetch_wait_s"],
                   "page_hits": st1["hits"] - st0["hits"],
                   "page_misses": st1["misses"] - st0["misses"],
                   "evicted_bytes": st1["evicted_bytes"]
                   - st0["evicted_bytes"],
                   "cache_bytes": st1["cache_bytes"],
                   "launches": {k: v for k, v in counts.items() if v},
                   "range_overflows": sum(r.stats.range_overflows
                                          for r in got)}
            paged["runs"][name] = rec
            log(f"[17] paged {name}: {len(qs)} queries in {wall:.2f} s "
                f"({rec['queries_per_s']:.2f} queries/s), "
                f"{rec['chunk_steps']} chunk steps, page hits "
                f"{rec['page_hits']} misses {rec['page_misses']} evicted "
                f"{rec['evicted_bytes'] / 2 ** 20:.1f} MiB, waited "
                f"{rec['prefetch_wait_s']:.2f} s on prefetch; overflows "
                f"{rec['range_overflows']}; launches {rec['launches']}; "
                f"answers and SearchStats equal the resident engine's")
        if not paged["runs"]["ed_range_overflow"]["range_overflows"]:
            raise AssertionError("[17] the capacity-16 range run did not "
                                 "overflow")
        if pag.index.collection.is_materialized:
            raise AssertionError("[17] the paged engine read the whole "
                                 "payload")
        for key in executor.PAGED:
            executor.PAGED[key] = 0
        tr = trace_batch(torch, pag, pq, QuerySpec(k=K))
        tr["chunk_steps"] = executor.PAGED["chunks"]
        tr["launch_calls_per_step"] = tr["launch_calls"] / max(
            tr["chunk_steps"], 1)
        tr.pop("device_by_name")
        paged["traced_ed_batch"] = tr
        log(f"[17] one traced paged ED batch: {tr['chunk_steps']} chunk "
            f"steps, {tr['launch_calls']} kernel launch calls "
            f"({tr['launch_calls_per_step']:.2f} a step, the batch's "
            f"planning included), wall {tr['wall_s']:.2f} s, device busy "
            f"{tr['device_busy_s']:.4f} s (idle share "
            f"{tr['device_idle_share']:.3f})")
        out["paged"] = paged
        log(f"[17] paged scans over {paged_series} series (payload "
            f"{paged['payload_bytes'] / 2 ** 20:.1f} MiB, budget "
            f"{budget / 2 ** 20:.1f} MiB): every answer and SearchStats "
            f"equal the resident engine's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, appended


def serve_phase(torch, engine, data, p, zero_counts, read_counts, seed):
    """[18], serving on the card: [3]'s engine behind
    `UlisseServer(engine, spec, ServeConfig(window_ms=2.0, max_batch=8))`.
    (a) warmup of SERVE_LENGTHS (fills 1, 2, 4 and 8), then one request
    alone (the first served latency; nothing built or loaded after the
    warmup); (b) SERVE_ED default-spec requests (windows of [3]'s series
    plus N(0, 0.1) noise at SERVE_LENGTHS, one bucket) from SERVE_CLIENTS
    closed-loop client threads, with the launch counters set to 0 just
    before and read just after, the process tracer on (no torch
    annotations) for the dispatch spans; every answer bit-equal to a
    serial engine.search of the same query afterwards, on the same
    snapshot; the served and the serial loop's queries/s; (c) the same for
    SERVE_DTW DTW requests (r = SERVE_DTW_R); (d) the writer lane under
    load: SERVE_WRITE ED requests (half windows of SERVE_APPEND new
    random-walk series) while append and compact are applied between
    dispatches (versions 1 and 2), every answer's snapshot in {0, 1, 2},
    every answer (and SERVE_LATE windows of the appended series served
    after the compact) held to a float64 brute force over its snapshot's
    series (5e-3; the appended windows found after version 1); (e) one query traced with torch annotations:
    the admission -> queue wait -> dispatch -> engine spans, device_scan
    inside the dispatch, the spans in a torch.profiler trace, and one
    scrape holding serving latency and the engine's pruning counters.
    Any failed ticket or check raises.  Returns the records."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core import QuerySpec
    from repro_torch.kernels import _build
    from repro_torch.serve import ServeConfig, UlisseServer
    from repro_torch.train.data import series_batches
    config = ServeConfig(window_ms=2.0, max_batch=8)
    rng = np.random.default_rng(seed + 18)
    out = {"config": {"window_ms": config.window_ms,
                      "max_batch": config.max_batch,
                      "clients": SERVE_CLIENTS,
                      "lengths": list(SERVE_LENGTHS)}}

    def windows(src, n):
        """n windows of `src` (+ N(0, 0.1)), SERVE_LENGTHS in turn."""
        qs = [None] * n
        for j, qlen in enumerate(SERVE_LENGTHS):
            idx = range(j, n, len(SERVE_LENGTHS))
            got, _ = window_batch(rng, src, rng.integers(
                0, src.shape[0], len(idx)), qlen)
            for i, q in zip(idx, got):
                qs[i] = q
        return qs

    def burst(server, qs, during=None):
        """Closed-loop clients, each submitting its share in turn and
        waiting for every answer: ([(ticket, result)], wall seconds)."""
        got = [None] * len(qs)
        errors = []

        def client(c):
            try:
                for i in range(c, len(qs), SERVE_CLIENTS):
                    t = server.submit(qs[i])
                    got[i] = (t, t.result(timeout=600))
            except Exception as e:         # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        if during is not None:
            during()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or None in got:
            raise AssertionError(f"[18] a served request failed: {errors}")
        return got, wall

    def served_record(server, wall, n, answered=None):
        """The burst's serving metrics; raises unless `answered` (default
        n) requests completed and none failed."""
        snap = server.metrics.snapshot()["total"]
        answered = n if answered is None else answered
        if snap["failed"] or snap["completed"] != answered:
            raise AssertionError(f"[18] {snap['failed']} failed, "
                                 f"{snap['completed']} of {answered} "
                                 f"completed")
        fills = {}
        for row in server.metrics.snapshot()["buckets"].values():
            for f, c in row["fill_hist"].items():
                fills[f] = fills.get(f, 0) + c
        return {"queries": n, "wall_s": wall, "queries_per_s": n / wall,
                "dispatches": snap["dispatches"],
                "mean_fill": snap["mean_fill"], "fill_hist": fills,
                "queue_wait_ms": snap["queue_wait_ms"],
                "latency_ms": snap["latency_ms"]}

    def serial_check(name, spec, got, qs):
        t0 = time.perf_counter()
        want = [engine.search(q, spec) for q in qs]
        wall = time.perf_counter() - t0
        same_results([r for _, r in got], want, f"[18] {name} served vs "
                     f"serial", stats=False)
        return {"wall_s": wall, "queries_per_s": len(qs) / wall}

    # -- (a) warmup and the first served request ----------------------------
    spec = QuerySpec(k=K)
    server = UlisseServer(engine, spec, config)
    t0 = time.perf_counter()
    traced = server.warmup(SERVE_LENGTHS)
    warm_s = time.perf_counter() - t0
    if traced != 3 * 4:
        raise AssertionError(f"[18] warmup exercised {traced} shapes, not 12")
    built = dict(_build.COUNTS)
    t0 = time.perf_counter()
    server.search(windows(data, 1)[0], timeout=600)
    first_ms = (time.perf_counter() - t0) * 1e3
    if _build.COUNTS != built:
        raise AssertionError(f"[18] the first request after warmup built or "
                             f"loaded kernels: {built} -> {_build.COUNTS}")
    out["warmup"] = {"shapes": traced, "s": warm_s,
                     "first_request_ms": first_ms, "build_counts": built}

    # -- (b) the ED k-NN burst ------------------------------------------------
    tracer = obs.get_tracer()
    ed_qs = windows(data, SERVE_ED)
    server.metrics.reset()
    tracer.configure(enabled=True, torch_annotations=False)
    tracer.drain()
    zero_counts()
    got, wall = burst(server, ed_qs)
    torch.cuda.synchronize()
    launches = read_counts(("fused_gather_ed_chunk", "pool_merge_partials",
                            "mindist_sym", "mindist_paa"))
    server.close()
    spans = tracer.drain()
    tracer.configure(enabled=False)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[18] {name} was not launched by the "
                                 f"served ED burst")
    rec = served_record(server, wall, SERVE_ED)
    rec["launches"] = launches
    disp = [s.dur for s in spans if s.name == "serve.dispatch"]
    batches = [s.dur for s in spans if s.name == "query.exact_device"]
    rec["dispatch_busy_s"] = sum(disp)
    rec["dispatch_busy_share"] = sum(disp) / wall
    rec["length_batches"] = len(batches)
    rec["length_batch_ms_mean"] = float(np.mean(batches)) * 1e3
    rec["serial"] = serial_check("ED", spec, got, ed_qs)
    # the GIL's share: the burst's most frequent dispatch fill, served
    # (median span) against the same number of the burst's queries in one
    # search with no client thread alive (median of three)
    fill = max(rec["fill_hist"], key=lambda f: (rec["fill_hist"][f], f))
    served = [s.dur for s in spans if s.name == "serve.dispatch"
              and (s.attrs or {}).get("fill") == fill]
    quiet = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.search(ed_qs[:fill], spec)
        quiet.append(time.perf_counter() - t0)
    rec["dispatch_fill"] = fill
    rec["served_dispatch_ms"] = float(np.median(served)) * 1e3
    rec["quiet_dispatch_ms"] = float(np.median(quiet)) * 1e3
    out["ed"] = rec
    log(f"[18] served ED k-NN: {SERVE_ED} requests from {SERVE_CLIENTS} "
        f"clients in {wall:.2f} s = {rec['queries_per_s']:.1f} queries/s "
        f"against the serial loop's {rec['serial']['queries_per_s']:.1f} "
        f"over the same queries ({rec['queries_per_s'] / rec['serial']['queries_per_s']:.2f}x); "
        f"{rec['dispatches']} dispatches, mean fill {rec['mean_fill']}, "
        f"fills {rec['fill_hist']}, {rec['length_batches']} length batches "
        f"({rec['length_batch_ms_mean']:.1f} ms mean); queue wait p50 "
        f"{rec['queue_wait_ms']['p50']} ms; latency p50/p95/p99 "
        f"{rec['latency_ms']['p50']}/{rec['latency_ms']['p95']}/"
        f"{rec['latency_ms']['p99']} ms (first request after warmup "
        f"{first_ms:.1f} ms, warmup {warm_s:.2f} s); dispatcher busy "
        f"{rec['dispatch_busy_share']:.3f} of the burst; a dispatch of "
        f"{fill} {rec['served_dispatch_ms']:.1f} ms served vs "
        f"{rec['quiet_dispatch_ms']:.1f} ms quiet; launches "
        f"{launches}; every answer bit-equal to serial")

    # -- (c) the DTW k-NN burst -----------------------------------------------
    dspec = QuerySpec(k=K, measure="dtw", r=SERVE_DTW_R)
    dtw_qs = windows(data, SERVE_DTW)
    server = UlisseServer(engine, dspec, config)
    zero_counts()
    got, wall = burst(server, dtw_qs)
    torch.cuda.synchronize()
    launches = read_counts(("fused_gather_lb_keogh_chunk", "dtw_survivors",
                            "pool_merge", "mindist_sym", "mindist_paa"))
    server.close()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[18] {name} was not launched by the "
                                 f"served DTW burst")
    rec = served_record(server, wall, SERVE_DTW)
    rec["launches"] = launches
    rec["serial"] = serial_check("DTW", dspec, got, dtw_qs)
    out["dtw"] = rec
    log(f"[18] served DTW k-NN (r {SERVE_DTW_R}): {SERVE_DTW} requests in "
        f"{wall:.2f} s = {rec['queries_per_s']:.2f} queries/s against the "
        f"serial loop's {rec['serial']['queries_per_s']:.2f}; "
        f"{rec['dispatches']} dispatches, mean fill {rec['mean_fill']}, "
        f"queue wait p50 {rec['queue_wait_ms']['p50']} ms, latency "
        f"p50/p95/p99 {rec['latency_ms']['p50']}/{rec['latency_ms']['p95']}"
        f"/{rec['latency_ms']['p99']} ms; launches {launches}; every answer "
        f"bit-equal to serial")

    # -- (d) the writer lane under load ---------------------------------------
    base = engine.index.collection.data
    n_base = base.shape[0]
    new = series_batches(SERVE_APPEND, data.shape[1], seed=seed + 18)
    wr_qs = [q for pair in zip(windows(data, SERVE_WRITE // 2),
                               windows(new, SERVE_WRITE // 2)) for q in pair]
    appended = [i % 2 == 1 for i in range(len(wr_qs))]
    server = UlisseServer(engine, spec, config)
    ops = {}

    def writer():
        # append under load, let the next dispatch serve version 1, then
        # compact
        time.sleep(0.05)
        ops["append"] = server.append(new)
        ops["append"].result(timeout=600)
        done = server.metrics.snapshot()["total"]["completed"]
        t0 = time.perf_counter()
        while (server.metrics.snapshot()["total"]["completed"] == done
               and time.perf_counter() - t0 < 5.0):
            time.sleep(0.005)
        ops["compact"] = server.compact()

    zero_counts()
    t0 = time.perf_counter()
    got, wall = burst(server, wr_qs, during=writer)
    versions = [ops[k].result(timeout=600) for k in ("append", "compact")]
    late_idx = [i for i, a in enumerate(appended) if a][:SERVE_LATE]
    late = [server.search(wr_qs[i], timeout=600) for i in late_idx]
    torch.cuda.synchronize()
    launches = read_counts(("envelope_znorm", "fused_gather_ed_chunk"))
    server.close()
    if versions != [1, 2] or server.version != 2 or [
            ops[k].snapshot for k in ("append", "compact")] != [1, 2]:
        raise AssertionError(f"[18] writer versions {versions}")
    if launches["envelope_znorm"] <= 0:
        raise AssertionError("[18] the append did not launch envelope_znorm")
    snaps = [t.snapshot for t, _ in got]
    if not set(snaps) <= {0, 1, 2}:
        raise AssertionError(f"[18] snapshots {sorted(set(snaps))}")
    rec = served_record(server, wall, SERVE_WRITE, SERVE_WRITE + len(late))
    grown = torch.cat([base, torch.from_numpy(new).to(base.device)])
    checks = [(q, res, t.snapshot, app)
              for q, (t, res), app in zip(wr_qs, got, appended)]
    checks += [(wr_qs[i], r, 2, True) for i, r in zip(late_idx, late)]
    tb = time.perf_counter()
    # one brute force a (snapshot's series, query length)
    groups = {}
    for j, (q, _, snap, _) in enumerate(checks):
        groups.setdefault((min(snap, 1), len(q)), []).append(j)
    oracle = {}
    for (grown_set, _), js in groups.items():
        for j, o in zip(js, brute64_ed(
                torch, grown if grown_set else base,
                [checks[j][0] for j in js], K, p.znorm)):
            oracle[j] = o
    worst, found_after = 0.0, 0
    for j, (q, res, snap, app) in enumerate(checks):
        series, offsets, dists = oracle[j]
        err = float(np.abs(res.dists - dists).max())
        worst = max(worst, err)
        if err > 5e-3:
            raise AssertionError(f"[18] snapshot {snap}: served {res.dists} "
                                 f"vs float64 brute force {dists}")
        if app and snap >= 1:
            if not (res.series[0] == series[0] >= n_base):
                raise AssertionError(
                    f"[18] an appended window served at snapshot {snap} "
                    f"found series {res.series[0]}, not the appended "
                    f"{series[0]}")
            found_after += 1
    del grown
    rec.update(launches=launches, versions=versions,
               snapshots={s: snaps.count(s) for s in sorted(set(snaps))},
               brute_checked=len(checks), brute_max_abs_err=worst,
               appended_found_after_v1=found_after,
               brute_s=time.perf_counter() - tb, appended=SERVE_APPEND)
    if not found_after:
        raise AssertionError("[18] no appended window was served after "
                             "version 1")
    out["writer"] = rec
    log(f"[18] writer lane: {SERVE_WRITE} ED requests from "
        f"{SERVE_CLIENTS} clients while {SERVE_APPEND} series were "
        f"appended (version 1) and compacted (version 2) between "
        f"dispatches, {wall:.2f} s; answers by snapshot {rec['snapshots']}; "
        f"{len(checks)} answers ({found_after} appended windows found "
        f"after version 1) equal a float64 brute "
        f"force over their snapshot (max |d - d_brute| {worst:.2e}, "
        f"{rec['brute_s']:.1f} s); launches {launches}")

    # -- (e) one traced query and the scrape ----------------------------------
    server = UlisseServer(engine, spec, config)
    server.warmup([SERVE_LENGTHS[0]], [1])
    tracer.configure(enabled=True, torch_annotations=True)
    tracer.drain()
    q = windows(data, 1)[0]
    try:
        # the profiler records other threads' ranges (the dispatcher's)
        # only with profile_all_threads, which older torch lacks
        from torch._C._profiler import _ExperimentalConfig
        all_threads = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        all_threads = None
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=all_threads) as prof:
            server.search(q, timeout=600)
            server.close()             # joins the dispatcher
        doc = tracer.chrome_trace(clear=True)
    finally:
        tracer.configure(enabled=False, torch_annotations=False)
    text = server.metrics_text()
    evs = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            evs.setdefault(e["name"], e)
    missing = [n for n in SERVE_SPANS if n not in evs]
    if missing:
        raise AssertionError(f"[18] the trace lacks {missing}")
    d, s = evs["serve.dispatch"], evs["device_scan"]
    if not (d["ts"] <= s["ts"] and s["ts"] + s["dur"]
            <= d["ts"] + d["dur"] + 1):
        raise AssertionError("[18] device_scan lies outside the dispatch")
    annotated = {ev.name for ev in prof.events()} & set(SERVE_SPANS)
    if all_threads is not None and "device_scan" not in annotated:
        raise AssertionError("[18] the spans are not in the torch.profiler "
                             "trace")
    for line in ("ulisse_serve_latency_seconds_bucket",
                 'ulisse_engine_true_dist_computations{backend="device"}'):
        if line not in text:
            raise AssertionError(f"[18] the scrape lacks {line}")
    out["trace"] = {"span_ms": {n: evs[n]["dur"] / 1e3 for n in SERVE_SPANS},
                    "profiler_ranges": sorted(annotated),
                    "profile_all_threads": all_threads is not None,
                    "scrape_lines": len(text.splitlines())}
    log(f"[18] one traced served query (host ms): "
        + ", ".join(f"{n} {evs[n]['dur'] / 1e3:.2f}" for n in SERVE_SPANS)
        + f"; device_scan inside serve.dispatch; {len(annotated)} spans in "
        f"the torch.profiler trace (all threads: {all_threads is not None})"
        f"; the scrape ({len(text.splitlines())} "
        f"lines) holds ulisse_serve_latency_seconds_bucket and "
        f"ulisse_engine_true_dist_computations{{backend=\"device\"}}")
    return out


def check_gkth_entries(torch, engine, p, batches, answers, dtw_batches,
                       dtw_specs, dtw_answers, timings):
    """[19]'s kernel checks: the four k-NN chunk entries with the sharded
    scan's gkth, at the main path's shapes (B = 8, GKTH_ROWS rows, qlen
    256: [4]'s second ED batch and [8]'s second DTW batch on [3]'s index,
    the LB-sorted plan's first GKTH_CHUNKS chunks, under the batch's final
    pool and a gkth of half its k-th or the plan's bound 2.5 chunks in,
    the lesser, +inf for query 0).  ED (staged and
    long-row entries): the chunk entry + partials merge against the plain
    step, pools and counters bit for bit; LB (staged and long-row): the
    chunk entry's checks (lb2 at rtol 2e-4, mu, sd, ids and counters bit
    for bit, the survivor set at the min cut).  The staged entries are
    timed with and without gkth on the same chunks into `timings`.
    Returns the checks' record."""
    from repro_torch.core import executor, planner
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed_chunk, fused_gather_ed_chunk_long,
        fused_gather_lb_keogh_chunk, fused_gather_lb_keogh_chunk_long)
    index = engine.index
    coll, env = index.collection, index.envelopes
    dev = coll.data.device
    g, rows = p.gamma + 1, GKTH_ROWS
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    none = torch.full((BATCH, 1), env.size, dtype=torch.int32, device=dev)
    zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    rec = {}
    for measure, qs, ans, r in (("ed", batches[1], answers[1], 0),
                                ("dtw", dtw_batches[1], dtw_answers[1],
                                 dtw_specs[1].r)):
        q = torch.from_numpy(np.stack(qs)).to(dev)
        qlen = q.shape[1]
        qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
            q, p.seg_len, p.znorm, measure, r)
        lbs = planner.env_lower_bounds_batch(
            qb, qh, env, index.breakpoints, p.seg_len,
            p.query_segments(qlen), False)
        plan = planner.device_scan_pack(
            env.series_id, env.anchor, env.n_master, lbs, none, zero,
            chunk=1, n_pad=executor.pow2ceil(env.size))[:4]
        pool0 = [torch.from_numpy(np.stack([a.dists ** 2 for a in ans])
                                  .astype(np.float32)).to(dev),
                 *(torch.from_numpy(np.stack([getattr(a, f) for a in ans])
                                    .astype(np.int32)).to(dev)
                   for f in ("series", "offsets"))]
        # gkth: half the final k-th, or the bound 2.5 chunks into the plan
        # where that is less (so the cut prunes rows of the checked
        # chunks); +inf for query 0
        gk = torch.minimum(0.5 * pool0[0][:, -1],
                           plan[3][:, rows * GKTH_CHUNKS * 5 // 16]
                           ).contiguous()
        gk[0] = float("inf")
        if measure == "ed":
            pruned = {}
            for entry in (fused_gather_ed_chunk, fused_gather_ed_chunk_long):
                pool = [t.clone() for t in pool0]
                plain = [t.clone() for t in pool0]
                st = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
                st_p = torch.zeros_like(st)
                for i in range(GKTH_CHUNKS):
                    ed_step_pair(torch, a0, plan, qn, pool, plain, st, st_p,
                                 i, rows, g, p.znorm, gkth=gk, entry=entry)
                pruned[entry.__name__] = int(st[:, 5].sum())
            rec["ed"] = {"pruned_rows": pruned, "bit_equal": True}
            name = "fused_gather_ed_chunk"
        else:
            surv = {}
            for entry in (fused_gather_lb_keogh_chunk,
                          fused_gather_lb_keogh_chunk_long):
                worst, n_s = 0.0, 0
                for i in range(GKTH_CHUNKS):
                    lb_in, kw, got, st, _ = chunk_args(
                        torch, a0, qn, dlo, dhi, plan, i, rows, pool0[0], g,
                        znorm=p.znorm, gkth=gk, entry=entry)
                    err, n = check_chunk_entry(torch, lb_in, kw, got, st)
                    worst, n_s = max(worst, err), n_s + n
                surv[entry.__name__] = {"survivors": n_s,
                                        "lb2_max_abs_err": worst}
            rec["dtw"] = surv
            name = "fused_gather_lb_keogh_chunk"
        for mode, gkk in (("pool", None), ("gkth", gk)):
            st = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
            extra = {} if gkk is None else {"gkth": gkk}
            if measure == "ed":
                call = [lambda i=i: fused_gather_ed_chunk(
                    *a0, *plan, qn, pool0[0], st, i=i, chunk=rows, g=g,
                    znorm=p.znorm, **extra) for i in range(GKTH_CHUNKS)]
                plain = [lambda i=i: ref.fused_gather_ed_chunk_ref(
                    *a0, *plan, qn, pool0[0], st.clone(), i=i, chunk=rows,
                    g=g, znorm=p.znorm, gkth=gkk)
                    for i in range(GKTH_CHUNKS)]
                nbytes, ops, n_ok = ed_chunk_work(
                    torch, coll, plan, pool0[0], qlen, rows, g, GKTH_CHUNKS,
                    gkth=gkk)
                shape = f"B={BATCH} rows={rows} qlen={qlen} ok/call={n_ok:.0f}"
                events = 1
            else:
                steps = [chunk_args(torch, a0, qn, dlo, dhi, plan, i, rows,
                                    pool0[0], g, znorm=p.znorm, gkth=gkk)
                         for i in range(GKTH_CHUNKS)]
                call = [lambda c=c: fused_gather_lb_keogh_chunk(
                    *c[0], c[3], **c[1]) for c in steps]
                plain = [lambda c=c: ref.fused_gather_lb_keogh_chunk_ref(
                    *c[0], c[3].clone(), **c[1]) for c in steps]
                per_call = sum(int(c[2][4].sum()) for c in steps) / len(steps)
                nbytes, ops, n_ok = lb_chunk_work(
                    torch, coll, plan, pool0[0], qlen, rows, g, len(steps),
                    per_call, gkth=gkk)
                shape = (f"B={BATCH} rows={rows} qlen={qlen} ok/call="
                         f"{n_ok:.0f} surv/call={per_call:.0f}")
                events = 2
            timings[(name, qlen, rows, mode)] = timing(
                torch, call, plain, nbytes, ops, 0.0, shape, events=events)
    return rec


def check_gmap_entries(torch, engine, data, p, batches, answers,
                       dtw_batches, dtw_specs, dtw_answers, part, timings):
    """[20]'s kernel checks: the two k-NN chunk entries as the sharded
    scan's delta family runs them, with gkth and a gmap over a rank's
    [main; delta] block (GMAP_MAIN of [3]'s series and the first
    GMAP_DELTA of [17]'s appended part, their global ids), its envelope
    set packed delta-first with pinned chunk heads: [4]'s second ED and
    [8]'s second DTW batch (B = 8, qlen 256), the plan's first GKTH_CHUNKS
    chunks of GKTH_ROWS rows (the delta's, then the main rows'), from an
    empty pool under a gkth of the batch's final k-th (+inf for query 0).
    ED: the chunk entry + gmap + partials merge against the plain step,
    pools (global ids) and counters bit for bit; LB: the chunk entry's
    checks (lb2 rtol 2e-4, mu, sd, ids and counters bit for bit, the
    survivor set at the cut).  Both timed on these chunks into
    `timings` under mode "gkth+gmap".  Returns the checks' record."""
    from repro_torch.core import Collection, executor, planner
    from repro_torch.core.envelope import build_envelope_set
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import (fused_gather_ed_chunk,
                                                  fused_gather_lb_keogh_chunk)
    dev = engine.device
    bp = engine.index.breakpoints
    block = np.concatenate([data[:GMAP_MAIN], part[:GMAP_DELTA]])
    coll = Collection.from_array(block, device=dev)
    env = build_envelope_set(coll, p, bp)
    d_rows = GMAP_DELTA * p.num_envelopes(SERIES_LEN)
    gmap = torch.from_numpy(np.concatenate([
        np.arange(GMAP_MAIN), len(data) + np.arange(GMAP_DELTA),
        [-1]]).astype(np.int32)).to(dev)
    g, rows = p.gamma + 1, GKTH_ROWS
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    rec = {"block": [GMAP_MAIN, GMAP_DELTA]}
    for measure, qs, ans, r in (("ed", batches[1], answers[1], 0),
                                ("dtw", dtw_batches[1], dtw_answers[1],
                                 dtw_specs[1].r)):
        q = torch.from_numpy(np.stack(qs)).to(dev)
        qlen = q.shape[1]
        qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
            q, p.seg_len, p.znorm, measure, r)
        lbs = planner.env_lower_bounds_batch(
            qb, qh, env, bp, p.seg_len, p.query_segments(qlen), False)
        n_pad, chunk, nd_pad = executor.shard_pack_geometry(
            env.size, d_rows, rows)
        plan = planner.device_shard_pack(
            env.series_id, env.anchor, env.n_master, lbs, n_pad=n_pad,
            n_delta=d_rows, chunk=chunk)
        gk = torch.from_numpy(np.array([a.dists[-1] ** 2 for a in ans],
                                       np.float32)).to(dev)
        gk[0] = float("inf")
        empty = [torch.full((BATCH, K), float("inf"), device=dev),
                 torch.full((BATCH, K), -1, dtype=torch.int32, device=dev),
                 torch.full((BATCH, K), -1, dtype=torch.int32, device=dev)]
        if measure == "ed":
            pool = [t.clone() for t in empty]
            plain = [t.clone() for t in empty]
            st = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
            st_p = torch.zeros_like(st)
            for i in range(GKTH_CHUNKS):
                ed_step_pair(torch, a0, plan, qn, pool, plain, st, st_p, i,
                             rows, g, p.znorm, gkth=gk, gmap=gmap)
            sid = pool[1][pool[1] >= 0]
            rec["ed"] = {"bit_equal": True, "delta_chunks": nd_pad // chunk,
                         "chunks_visited": int(st[:, 0].sum()),
                         "pruned_rows": int(st[:, 5].sum()),
                         "delta_ids_in_pool": int((sid >= len(data)).sum())}
            call = [lambda i=i: fused_gather_ed_chunk(
                *a0, *plan, qn, empty[0], st, i=i, chunk=rows, g=g,
                znorm=p.znorm, gkth=gk) for i in range(GKTH_CHUNKS)]
            plain_call = [lambda i=i: ref.fused_gather_ed_chunk_ref(
                *a0, *plan, qn, empty[0], st.clone(), i=i, chunk=rows, g=g,
                znorm=p.znorm, gkth=gk) for i in range(GKTH_CHUNKS)]
            nbytes, ops, n_ok = ed_chunk_work(
                torch, coll, plan, empty[0], qlen, rows, g, GKTH_CHUNKS,
                gkth=gk)
            shape = f"B={BATCH} rows={rows} qlen={qlen} ok/call={n_ok:.0f}"
            name, events = "fused_gather_ed_chunk", 1
        else:
            worst, n_s, steps = 0.0, 0, []
            for i in range(GKTH_CHUNKS):
                c = chunk_args(torch, a0, qn, dlo, dhi, plan, i, rows,
                               empty[0], g, znorm=p.znorm, gkth=gk)
                err, n = check_chunk_entry(torch, c[0], c[1], c[2], c[3])
                worst, n_s = max(worst, err), n_s + n
                steps.append(c)
            rec["dtw"] = {"survivors": n_s, "lb2_max_abs_err": worst}
            call = [lambda c=c: fused_gather_lb_keogh_chunk(
                *c[0], c[3], **c[1]) for c in steps]
            plain_call = [lambda c=c: ref.fused_gather_lb_keogh_chunk_ref(
                *c[0], c[3].clone(), **c[1]) for c in steps]
            per_call = sum(int(c[2][4].sum()) for c in steps) / len(steps)
            nbytes, ops, n_ok = lb_chunk_work(
                torch, coll, plan, empty[0], qlen, rows, g, len(steps),
                per_call, gkth=gk)
            shape = (f"B={BATCH} rows={rows} qlen={qlen} ok/call="
                     f"{n_ok:.0f} surv/call={per_call:.0f}")
            name, events = "fused_gather_lb_keogh_chunk", 2
        timings[(name, qlen, rows, "gkth+gmap")] = timing(
            torch, call, plain_call, nbytes, ops,
            rec["dtw"]["lb2_max_abs_err"] if measure == "dtw" else 0.0,
            shape, events=events)
    return rec


def ingest_rank(torch, dist, eng, data, world, rank, ing, wrappers):
    """[20] on one rank of a [19] world, after its searches: (world 1
    first: the world-4 save opened here, re-sharded and rebuilt, its ED
    and DTW batches) the part appended (envelope_znorm launches on this
    rank), [17]'s ED, DTW and range batches searched (answers, the chunk
    entries' launches, the steps that ran with a gmap), a save and a cold
    open of it in this world (seconds; the cold ED and DTW answers),
    compact (seconds) against a fresh sharded build of the grown
    collection with the same breakpoints (every shard field bit for bit;
    in world 1 the world-4 save's rebuild is that build), the ED batch
    after it, and (world 4) a served burst from rank 0 with the other
    ranks following, and an append through the writer lane.  Each step
    starts after a barrier.  Returns its records."""
    import os
    import shutil
    import threading
    from repro_torch.core import QuerySpec, UlisseEngine
    from repro_torch.distributed import ulisse
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    group = dist.group.WORLD
    part = np.load(ing["part"])
    specs = {n: QuerySpec(**kw) for n, kw in ing["specs"].items()}
    qs = ing["queries"]
    out = {}

    def zero():
        for w in wrappers.values():
            w.launches = 0
        ulisse.sharded_knn.gmap_steps = 0

    def timed(fn):
        dist.barrier()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def answers(e, names=tuple(specs)):
        return {n: [(a.dists, a.series, a.offsets, a.stats.as_dict())
                    for a in e.search(qs, specs[n])] for n in names}

    knn = ("ed", "dtw")
    elastic = None
    if ing.get("elastic"):
        elastic, open_s = timed(lambda: UlisseEngine.open(ing["elastic"],
                                                          mesh=group))
        got, search_s = timed(lambda: answers(elastic, knn))
        out["elastic"] = {"open_s": open_s, "search_s": search_s,
                          "rows": elastic.raw_data.shape[0],
                          "delta_size": elastic.delta_size,
                          "cold": elastic._shard.sections is not None,
                          "answers": got}
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ing["elastic"], ignore_errors=True)
    zero()
    _, append_s = timed(lambda: eng.append(part))
    out["append"] = {"s": append_s, "delta_size": eng.delta_size,
                     "envelope_znorm": wrappers["envelope_znorm"].launches}
    zero()
    warm, search_s = timed(lambda: answers(eng))
    out["search"] = {"s": search_s, "answers": warm,
                     "gmap_steps": ulisse.sharded_knn.gmap_steps,
                     "launches": {n: w.launches
                                  for n, w in wrappers.items()}}
    path = os.path.join(ing["root"], f"world{world}")
    _, save_s = timed(lambda: eng.save(path))
    cold, open_s = timed(lambda: UlisseEngine.open(path, mesh=group))
    unbuilt = cold._shard.built is None
    got, first_s = timed(lambda: answers(cold, knn))
    out["save_open"] = {"save_s": save_s, "open_s": open_s,
                        "first_search_s": first_s, "unbuilt": unbuilt,
                        "bit_equal": all(
                            all(np.array_equal(x, y)
                                for x, y in zip(a[:3], b[:3]))
                            and a[3] == b[3]
                            for n in got for a, b in zip(got[n], warm[n]))}
    del cold
    torch.cuda.empty_cache()
    if not ing.get("keep_save"):
        dist.barrier()
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)
    bp = eng._shard.breakpoints
    _, compact_s = timed(eng.compact)
    if elastic is None:
        fresh, fresh_s = timed(lambda: UlisseEngine.distributed(
            None, eng.params, np.concatenate([data, part]), breakpoints=bp))
    else:      # the world-4 save of the same rows and breakpoints, rebuilt
        fresh, fresh_s = elastic, out["elastic"]["open_s"]
    a, b = eng._shard, fresh._shard
    diff = [f for f in ("data", "csum", "csum2", "csum_lo", "csum2_lo",
                        "center")
            if not torch.equal(getattr(a.index.collection, f),
                               getattr(b.index.collection, f))]
    diff += [f for f in ("paa_lo", "paa_hi", "sym_lo", "sym_hi",
                         "series_id", "anchor", "n_master", "valid")
             if not torch.equal(getattr(a.index.envelopes, f),
                                getattr(b.index.envelopes, f))]
    if not np.array_equal(a.main_rows, b.main_rows):
        diff.append("main_rows")
    if not torch.equal(a.breakpoints, b.breakpoints):
        diff.append("breakpoints")
    del fresh, a, b, elastic
    torch.cuda.empty_cache()
    out["compact"] = {"s": compact_s, "fresh_build_s": fresh_s,
                      "differences": diff, "delta_size": eng.delta_size,
                      "answers": answers(eng, ("ed",))}
    sv = ing.get("serve")
    if sv is not None:
        spec = QuerySpec(k=K)
        serial = [eng.search(q, spec) for q in sv["queries"]]
        if rank == 0:
            server = UlisseServer(eng, spec, ServeConfig(window_ms=2.0,
                                                         max_batch=BATCH))
            got = [None] * len(sv["queries"])

            def client(c):
                for i in range(c, len(got), SERVE20_CLIENTS):
                    got[i] = server.search(sv["queries"][i], timeout=300)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE20_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            served_s = time.perf_counter() - t
            version = server.append(np.load(sv["part"])).result(300)
            probe = server.search(sv["probe"], timeout=300)
            server.close()
            out["serve"] = {
                "served_s": served_s, "version": version,
                "bit_equal": all(
                    np.array_equal(x.series, y.series)
                    and np.array_equal(x.offsets, y.offsets)
                    and np.array_equal(x.dists, y.dists)
                    and x.stats.as_dict() == y.stats.as_dict()
                    for x, y in zip(got, serial)),
                "probe": (probe.series[:1].tolist(),
                          probe.offsets[:1].tolist()),
                "dispatches": server.metrics.snapshot()["total"]}
        else:
            out["serve"] = {"replayed": follow(eng)}
    return out


def sharded_rank(rank, world, backend, tmp, npy, params, jobs, ingest=None):
    """One rank of a [19] world: join it (a file:// rendezvous in `tmp`),
    build this rank's shard of the collection at `npy` (mmap'd) through
    `UlisseEngine.distributed` on its default device (cuda:0), run every
    job — (name, [(queries, QuerySpec keywords)]) — with the kernel
    counters, the collectives' counters and the sharded scan's rounds and
    steps set to 0 just before it (after a barrier) and read just after,
    then [20] (`ingest_rank`, with `ingest` its inputs), and pickle its
    records to `tmp`."""
    import importlib
    import pickle
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, 8 // (world + 1)))
    torch.cuda.set_device(0)
    sys.path.insert(0, str(SRC))
    from repro_torch.core import EnvelopeParams, QuerySpec, UlisseEngine
    from repro_torch.distributed import collectives, ulisse
    wrappers = {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), name) for mod, name in SHARDED_WRAPPERS}
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        data = np.load(npy, mmap_mode="r")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        eng = UlisseEngine.distributed(None, EnvelopeParams(**params), data)
        torch.cuda.synchronize()
        out = {"build_s": time.perf_counter() - t0, "device": str(eng.device),
               "backend": str(dist.get_backend()),
               "build_launches": {n: w.launches for n, w in wrappers.items()
                                  if w.launches}}
        for name, runs in jobs:
            for w in wrappers.values():
                w.launches = 0
            collectives.STATS.update(calls=0, seconds=0.0)
            ulisse.sharded_knn.rounds = ulisse.sharded_knn.steps = 0
            dist.barrier()
            t = time.perf_counter()
            res = []
            for qs, kw in runs:
                res += eng.search(qs, QuerySpec(**kw))
            torch.cuda.synchronize()
            out[name] = {
                "wall_s": time.perf_counter() - t, "queries": len(res),
                "batches": len(runs), "rounds": ulisse.sharded_knn.rounds,
                "steps": ulisse.sharded_knn.steps,
                "collective_s": collectives.STATS["seconds"],
                "collective_calls": collectives.STATS["calls"],
                "launches": {n: w.launches for n, w in wrappers.items()},
                "answers": [(a.dists, a.series, a.offsets, a.stats.as_dict())
                            for a in res]}
        if ingest is not None:
            out["ingest"] = ingest_rank(torch, dist, eng, data, world, rank,
                                        ingest, wrappers)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_sharded_world(world: int, backend: str, npy: str, jobs,
                      ingest=None) -> list:
    """Start `world` ranks of `sharded_rank` (spawn: CUDA cannot fork),
    wait for them (SHARDED_TIMEOUT_S, then kill them and fail), and return
    their records in rank order.  A rank's exception fails the phase."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            sharded_rank, args=(world, backend, tmp, npy, BENCH, jobs,
                                ingest),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.01)):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"[19] the world of {world} ({backend}) did not end "
                        f"in {SHARDED_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        out = []
        for rank in range(world):
            with open(f"{tmp}/rank{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _same_knn(got, want, measure: str, what: str) -> float:
    """A rank's (dists, series, offsets, stats) against a local
    SearchResult: the same (sid, off) in the same order, ED distances
    within 1e-9 (both float64 rescores), DTW rtol 1e-4.  Returns the
    largest distance difference."""
    d, s, o, _ = got
    if not (np.array_equal(s, want.series)
            and np.array_equal(o, want.offsets)):
        raise AssertionError(f"[19] {what}: answers {list(zip(s, o))} != "
                             f"local {list(zip(want.series, want.offsets))}")
    diff = float(np.abs(d - want.dists).max()) if len(d) else 0.0
    tol = (1e-9 if measure == "ed"
           else 1e-4 * float(np.abs(want.dists).max()) + 1e-12)
    if diff > tol:
        raise AssertionError(f"[19] {what}: distances differ by {diff}")
    return diff


def _same_hits(got, want, eps: float, what: str) -> int:
    """A rank's range answer against the local one: the same (sid, off)
    set but for windows whose distance lies within RANGE_BAND of eps (the
    host continuation rounds otherwise).  Returns the windows in either
    set alone."""
    d, s, o, _ = got
    mine = dict(zip(zip(s.tolist(), o.tolist()), d.tolist()))
    theirs = dict(zip(zip(want.series.tolist(), want.offsets.tolist()),
                      want.dists.tolist()))
    edge = 0
    for key in set(mine) ^ set(theirs):
        dist_ = mine.get(key, theirs.get(key))
        if abs(dist_ - eps) > RANGE_BAND:
            raise AssertionError(f"[19] {what}: window {key} at {dist_} "
                                 f"(eps {eps}) in one answer only")
        edge += 1
    return edge


def sharded_phase(torch, engine, data, p, batches, answers, dtw_batches,
                  dtw_specs, dtw_answers, range_cases, range_records,
                  range_answers, timings, appended, range_eps, card, seed):
    """[19], the sharded search on the card.  The gkth entries against
    their plain versions (`check_gkth_entries`), then [3]'s collection
    written once to a temporary .npy and served by
    `UlisseEngine.distributed` in a world of 1 over NCCL and of 4 over
    gloo (every rank on cuda:0, 250,000 series a shard at full size),
    each rank mmapping it: [4]'s ED and [8]'s DTW batches as exact k-NN
    (the same (sid, off) in the same order as the local engine, ED within
    1e-9, DTW rtol 1e-4), and in the world of 4 also [16]'s range batches
    at capacity 2,048 and 16 (the local engine's hit sets), an
    approximate batch at max_leaves 1 and 64 and the ED batch at
    sync_every 1 and 64; every rank's answers and counters equal rank
    0's.  Then [20] in the same worlds (`check_gmap_entries` first, then
    `ingest_rank` on every rank, world 4 first, whose save world 1
    opens): `appended` is [17]'s part, the batch of its windows and the
    opened local engine's answers, which the sharded answers must equal.
    Returns the phase's record."""
    import os
    import shutil
    import tempfile
    from repro_torch.kernels import _build
    _build.load_all()           # the ranks load the libraries, not build
    rec = {"gkth": check_gkth_entries(torch, engine, p, batches, answers,
                                      dtw_batches, dtw_specs, dtw_answers,
                                      timings)}
    for key, t in timings.items():
        if len(key) == 4 and key[3] in ("pool", "gkth"):
            log(f"[19] {key[0]:27s} cut {key[3]:4s} {t['shape']:44s} kernel "
                f"{t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}, {t['timer']})")
    log(f"[19] the gkth chunk entries equal their plain versions: "
        f"{rec['gkth']}")
    new, aqs, before = appended
    rec["gmap"] = check_gmap_entries(torch, engine, data, p, batches,
                                     answers, dtw_batches, dtw_specs,
                                     dtw_answers, new, timings)
    for key, t in timings.items():
        if len(key) == 4 and key[3] == "gkth+gmap":
            log(f"[20] {key[0]:27s} gkth+gmap {t['shape']:44s} kernel "
                f"{t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}, {t['timer']}) "
                f"[{card}]")
    log(f"[20] the chunk entries with gkth and a gmap over a delta-first "
        f"plan equal their plain versions: {rec['gmap']}")
    big = max(RANGE_CAPS)
    knn_jobs = [("ed", [(b, dict(k=K)) for b in batches]),
                ("dtw", [(b, dict(k=K, measure="dtw", r=s.r))
                         for b, s in zip(dtw_batches, dtw_specs)])]
    range_jobs = []
    for case, (measure, qlen, r, qs) in zip(range_records, range_cases):
        for cap in RANGE_CAPS:
            sub = (range(DTW_BRUTE[qlen]) if cap < big and measure == "dtw"
                   else range(len(qs)))
            range_jobs.append((f"range-{measure}-{qlen}-{cap}", [(
                [qs[j] for j in sub], dict(
                    eps=case["eps"], measure=measure, r=r,
                    range_capacity=cap,
                    chunk_size=512 if cap == big else RANGE_SMALL_CHUNK))]))
    more = [(f"approx-{n}", [(batches[1], dict(k=K, mode="approx",
                                               max_leaves=n))])
            for n in (1, 64)]
    more += [(f"sync-{n}", [(batches[1], dict(k=K, sync_every=n))])
             for n in (1, 64)]
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    worlds = {}
    from repro_torch.train.data import series_batches
    srng = np.random.default_rng(seed + 20)
    serve_part = series_batches(SERVE20_APPEND, SERIES_LEN, seed=seed + 20)
    probe = (serve_part[7, 20:20 + QLENS[0]]
             + srng.normal(size=QLENS[0]).astype(np.float32) * 0.1)
    try:
        npy = os.path.join(tmpdir, "data.npy")
        np.save(npy, np.ascontiguousarray(data, np.float32))
        part_npy = os.path.join(tmpdir, "part.npy")
        np.save(part_npy, new)
        serve_npy = os.path.join(tmpdir, "serve_part.npy")
        np.save(serve_npy, serve_part)
        ingest = dict(part=part_npy, queries=aqs, root=tmpdir, specs={
            "ed": dict(k=K), "dtw": dict(k=K, measure="dtw",
                                         r=dtw_specs[0].r),
            "range": dict(eps=range_eps)})
        rec["disk_free_gib"] = shutil.disk_usage(tmpdir).free / 2 ** 30
        for world, backend in SHARDED_WORLDS:
            ing = dict(ingest)
            if world > 1:
                ing.update(keep_save=True, serve=dict(
                    queries=list(batches[0]) + list(batches[1]),
                    part=serve_npy, probe=probe))
            else:
                ing["elastic"] = os.path.join(tmpdir, "world4")
                # a buffer the batch's hits fit: world 4 runs the
                # overflow and its host tail, world 1 the plain scan
                ing["specs"] = dict(ing["specs"], range=dict(
                    eps=range_eps, range_capacity=RANGE20_WORLD1_CAP))
            t0 = time.perf_counter()
            worlds[world] = run_sharded_world(
                world, backend, npy,
                knn_jobs + (range_jobs + more if world > 1 else []), ing)
            rec[f"world_{world}_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    local = {"ed": [a for ans in answers for a in ans],
             "dtw": [a for ans in dtw_answers for a in ans]}
    paths = {"ed": ("fused_gather_ed_chunk", "pool_merge_partials",
                    "mindist_sym"),
             "dtw": ("fused_gather_lb_keogh_chunk", "dtw_survivors",
                     "pool_merge", "mindist_sym"),
             "range-ed": ("fused_gather_ed_range", "range_append"),
             "range-dtw": ("fused_gather_lb_keogh_range", "dtw_survivors",
                           "range_append")}
    for world, backend in SHARDED_WORLDS:
        ranks = worlds[world]
        r0 = ranks[0]
        for other in ranks[1:]:
            for name, run in r0.items():
                if not isinstance(run, dict) or "answers" not in run:
                    continue
                for a, b in zip(other[name]["answers"], run["answers"]):
                    if not (all(np.array_equal(x, y)
                                for x, y in zip(a[:3], b[:3]))
                            and a[3] == b[3]):
                        raise AssertionError(f"[19] world {world}: {name}'s "
                                             f"answers differ across ranks")
        wrec = {"backend": backend, "build_s": [r["build_s"] for r in ranks],
                "build_launches": r0["build_launches"], "runs": {}}
        worst = 0.0
        for name, run in r0.items():
            if not isinstance(run, dict) or "answers" not in run:
                continue
            walls = [r[name]["wall_s"] for r in ranks]
            launches = {n: sum(r[name]["launches"][n] for r in ranks)
                        for n in run["launches"]}
            kind = name.split("-")[0]
            measure = (name.split("-")[1] if kind == "range" else
                       "dtw" if name == "dtw" else "ed")
            for n in paths.get(name if kind != "range"
                               else f"range-{measure}", ()):
                if launches[n] <= 0:
                    raise AssertionError(f"[19] world {world}: {n} was not "
                                         f"launched on {name}")
            got = run["answers"]
            if name in ("ed", "dtw"):
                for j, (a, b) in enumerate(zip(got, local[name])):
                    worst = max(worst, _same_knn(a, b, name,
                                                 f"world {world} {name} {j}"))
            elif kind in ("sync", "approx"):
                for j, (a, b) in enumerate(zip(got, answers[1])):
                    if kind == "sync" or a[3]["exact_from_approx"]:
                        _same_knn(a, b, "ed", f"world {world} {name} {j}")
                    elif a[0][-1] < b.dists[-1] - 1e-9:
                        raise AssertionError(f"[19] {name}: k-th below the "
                                             f"exact one")
            else:
                _, qlen, cap = name.split("-")[1:]
                want = range_answers[(measure, int(qlen))][big]
                eps = next(c["eps"] for c in range_records
                           if c["measure"] == measure
                           and c["qlen"] == int(qlen))
                edge = sum(_same_hits(a, want[j], eps,
                                      f"world {world} {name} {j}")
                           for j, a in enumerate(got))
            stats = [a[3] for a in got]
            wrec["runs"][name] = {
                "queries": run["queries"], "batches": run["batches"],
                "wall_s": walls, "queries_per_s": run["queries"] / max(walls),
                "rounds_per_batch": run["rounds"] / run["batches"],
                "collective_share": [r[name]["collective_s"]
                                     / r[name]["wall_s"] for r in ranks],
                "collective_calls": run["collective_calls"],
                "steps_per_rank": [r[name]["steps"] for r in ranks],
                "mean_shard_chunks": np.mean(
                    [s["shard_chunks"] for s in stats], axis=0).tolist(),
                "mean_chunks_visited": float(np.mean(
                    [s["chunks_visited"] for s in stats])),
                "overflows": sum(s["range_overflows"] for s in stats),
                "exact_from_approx": float(np.mean(
                    [s["exact_from_approx"] for s in stats])),
                "launches": launches}
            if kind == "range":
                wrec["runs"][name]["edge_windows"] = edge
            x = wrec["runs"][name]
            log(f"[19] world {world} ({backend}) {name:18s} "
                f"{x['queries_per_s']:.2f} queries/s, "
                f"{x['rounds_per_batch']:.1f} rounds a batch, collectives "
                f"{100 * max(x['collective_share']):.1f}% of wall (host "
                f"clock, most of a rank), chunk steps a rank "
                f"{x['steps_per_rank']}, mean shard_chunks "
                f"{[round(c, 1) for c in x['mean_shard_chunks']]}, "
                f"overflows {x['overflows']}")
        if world > 1:
            on = sum(a[3]["chunks_visited"] for a in r0["sync-1"]["answers"])
            off = sum(a[3]["chunks_visited"]
                      for a in r0["sync-64"]["answers"])
            if on > off:
                raise AssertionError(f"[19] sync_every 1 visited {on} "
                                     f"chunks, more than 64's {off}")
        wrec["max_distance_diff"] = worst
        rec[f"world_{world}"] = wrec
        log(f"[19] world {world} ({backend}, every rank on cuda:0): build "
            f"{max(wrec['build_s']):.1f} s a rank, answers equal the local "
            f"engine's (max |d - d_local| {worst:.2e}) and across ranks; "
            f"{rec[f'world_{world}_s']:.1f} s in all")
    rec["ingest"] = {world: ingest_checks(worlds[world], world, backend,
                                          p, len(data), before, range_eps,
                                          card)
                     for world, backend in SHARDED_WORLDS}
    return rec


class _Result:
    """A rank's (dists, series, offsets) as `_same_knn`'s local side."""

    def __init__(self, dists, series, offsets):
        self.dists, self.series, self.offsets = dists, series, offsets


def _same_ingest(got, before, eps: float, what: str) -> float:
    """A rank's [20] ED / DTW (/ range) answers against the local engine's
    after the same append ([17]'s); returns the largest distance
    difference of the k-NN answers."""
    worst = 0.0
    for name in ("ed", "dtw"):
        for j, (a, b) in enumerate(zip(got[name], before[name])):
            worst = max(worst, _same_knn(a, b, name, f"{what} {name} {j}"))
    for j, (a, b) in enumerate(zip(got.get("range", ()), before["range"])):
        _same_hits(a, b, eps, f"{what} range {j}")
    return worst


def ingest_checks(ranks, world: int, backend: str, p, n0: int, before,
                  eps: float, card: str) -> dict:
    """[20]'s gates on one world's rank records (`ingest_rank`), and its
    record: the append launched envelope_znorm on every rank and grew
    delta_size; the searches after it equal the local engine's after the
    same append ([17]), on every rank, and ran every k-NN step through a
    gkth chunk entry and a gmap; the cold open's k-NN answers were the
    warm engine's bit for bit, its index unbuilt until the first search;
    compact equalled a fresh sharded build in every shard field and
    answered as before; (world 1) the world-4 save opened here answered
    as the local engine; (world 4) every served answer equalled serial
    search and the writer lane's append was found."""
    r0 = [r["ingest"] for r in ranks]
    what = f"[20] world {world}"
    delta = APPEND_SERIES * p.num_envelopes(SERIES_LEN)
    for r in r0:
        if r["append"]["envelope_znorm"] <= 0:
            raise AssertionError(f"{what}: a rank's append launched no "
                                 f"envelope_znorm")
        if r["append"]["delta_size"] != delta:
            raise AssertionError(f"{what}: delta_size "
                                 f"{r['append']['delta_size']}")
    worst = max(_same_ingest(r["search"]["answers"], before, eps,
                             f"{what} rank {i}") for i, r in enumerate(r0))
    launches = {n: sum(r["search"]["launches"][n] for r in r0)
                for n in r0[0]["search"]["launches"]}
    gmap_steps = sum(r["search"]["gmap_steps"] for r in r0)
    knn_launches = (launches["fused_gather_ed_chunk"]
                    + launches["fused_gather_lb_keogh_chunk"])
    if min(launches["fused_gather_ed_chunk"],
           launches["fused_gather_lb_keogh_chunk"]) <= 0 \
            or gmap_steps != knn_launches:
        raise AssertionError(f"{what}: {gmap_steps} gmap steps against "
                             f"{launches} chunk-entry launches")
    for r in r0:
        so, c = r["save_open"], r["compact"]
        if not (so["bit_equal"] and so["unbuilt"]):
            raise AssertionError(f"{what}: the cold open {so}")
        if c["differences"] or c["delta_size"]:
            raise AssertionError(f"{what}: compact differs from a fresh "
                                 f"build in {c['differences']}")
        for j, (a, b) in enumerate(zip(c["answers"]["ed"],
                                       r["search"]["answers"]["ed"])):
            _same_knn(a, _Result(*b[:3]), "ed", f"{what} compacted ed {j}")
    out = {"backend": backend, "append_s": [r["append"]["s"] for r in r0],
           "envelope_znorm_launches": [r["append"]["envelope_znorm"]
                                       for r in r0],
           "search_s": max(r["search"]["s"] for r in r0),
           "launches": launches, "gmap_steps": gmap_steps,
           "save_s": max(r["save_open"]["save_s"] for r in r0),
           "open_s": max(r["save_open"]["open_s"] for r in r0),
           "cold_first_search_s": max(r["save_open"]["first_search_s"]
                                      for r in r0),
           "compact_s": max(r["compact"]["s"] for r in r0),
           "fresh_build_s": max(r["compact"]["fresh_build_s"] for r in r0),
           "max_distance_diff": worst}
    log(f"[20] world {world} ({backend}): append of {APPEND_SERIES} series "
        f"{max(out['append_s']):.3f} s (envelope_znorm "
        f"{out['envelope_znorm_launches']} a rank); [17]'s ED, DTW and "
        f"range batches equal the local engine's after the same append "
        f"(max |d - d_local| {worst:.2e}) in {out['search_s']:.2f} s, "
        f"{knn_launches} chunk-entry launches with gkth and a gmap "
        f"(launches over the ranks: "
        f"{ {n: c for n, c in launches.items() if c} }); save "
        f"{out['save_s']:.2f} s, cold open "
        f"{out['open_s']:.3f} s, its first ED and DTW batches "
        f"{out['cold_first_search_s']:.2f} s, bit-equal; compact "
        f"{out['compact_s']:.2f} s, bit-equal to a fresh sharded build "
        f"({out['fresh_build_s']:.2f} s) [{card}]")
    if "elastic" in r0[0]:
        for i, r in enumerate(r0):
            e = r["elastic"]
            if (e["rows"], e["delta_size"], e["cold"]) != (
                    n0 + APPEND_SERIES, 0, False):
                raise AssertionError(f"{what}: the elastic open {e}")
            _same_ingest(e["answers"], before, eps,
                         f"{what} rank {i} elastic")
        e = r0[0]["elastic"]
        out["elastic"] = {"open_s": e["open_s"], "search_s": e["search_s"]}
        log(f"[20] world {world}: the world-4 save (with its delta) opened "
            f"here in {e['open_s']:.2f} s (re-sharded and rebuilt: the "
            f"fresh build compact is held to), its ED and DTW batches "
            f"{e['search_s']:.2f} s, equal to the local engine's [{card}]")
    if "serve" in r0[0]:
        sv = r0[0]["serve"]
        want = n0 + APPEND_SERIES + 7
        if not sv["bit_equal"] or sv["version"] != 1 \
                or sv["probe"][0] != [want]:
            raise AssertionError(f"{what}: the served burst {sv}")
        if any(r["serve"].get("replayed", 1) <= 0 for r in r0[1:]):
            raise AssertionError(f"{what}: a follower replayed nothing")
        out["serve"] = {"served_s": sv["served_s"],
                        "dispatches": sv["dispatches"],
                        "replayed": [r["serve"].get("replayed")
                                     for r in r0[1:]]}
        log(f"[20] world {world}: {2 * BATCH} requests served from rank 0 "
            f"({SERVE20_CLIENTS} client threads, the other ranks "
            f"following) in {sv['served_s']:.2f} s, bit-equal to serial "
            f"search; {SERVE20_APPEND} series appended through the writer "
            f"lane and found by the next dispatch (series {want}) [{card}]")
    return out


# -- [21] large g ------------------------------------------------------------

def brute64_dtw_lb(torch, data, q, r: int, znorm: bool, k: int = 0,
                   radius: float = 0.0):
    """Exact banded DTW in float64 on the card over every window of q's
    length, pruned by LB_Keogh in float64 (a true lower bound of the same
    DTW): every window's bound in blocks of series, then the plain DP
    (core/dtw.dtw_band) over the windows in bound order, a block at a
    time, until the next bound passes the k-th distance found (k > 0) or
    `radius` (the windows within it).  Returns (flat index series * n_off
    + offset, distance), numpy, sorted by (distance, index)."""
    from repro_torch.core import dtw
    qlen = len(q)
    s, n = data.shape
    n_off = n - qlen + 1
    rr = min(r, qlen - 1)
    qt = torch.from_numpy(np.asarray(q, np.float64)).to(data.device)
    if znorm:
        qt = (qt - qt.mean()) / qt.std(correction=0).clamp_min(1e-8)
    lo, hi = dtw.dtw_envelope(qt, rr)

    def windows(x):
        w = x.double()
        if znorm:
            w = (w - w.mean(-1, keepdim=True)) / w.std(
                -1, keepdim=True, correction=0).clamp_min(1e-8)
        return w
    block = max(1, BRUTE_ELEMS // (n_off * qlen))
    lbs = []
    for start in range(0, s, block):
        w = windows(data[start:start + block].unfold(1, qlen, 1))
        lbs.append(dtw.lb_keogh(lo, hi, w, squared=True).reshape(-1))
        del w
    lb = torch.cat(lbs)
    order = torch.argsort(lb)
    lb_sorted = lb[order]
    wins = data.unfold(1, qlen, 1)           # a view: windows by index
    best_d = torch.empty(0, dtype=torch.float64, device=data.device)
    best_i = torch.empty(0, dtype=torch.int64, device=data.device)
    # windows a DP step: the element budget of a brute-force block (the
    # DP's row loop runs once a step, so fewer, larger steps are faster)
    step = max(1 << 14, BRUTE_ELEMS // (qlen + 8 * (2 * rr + 1)))
    for pos in range(0, lb.numel(), step):
        cut = (radius * radius if k == 0 else
               float(best_d[k - 1]) if best_d.numel() >= k else float("inf"))
        if float(lb_sorted[pos]) > cut:
            break
        idx = order[pos:pos + step]
        d2 = dtw.dtw_band(qt, windows(wins[idx // n_off, idx % n_off]), rr,
                          squared=True)
        if k == 0:
            keep = d2 <= cut
            best_d, best_i = torch.cat([best_d, d2[keep]]), torch.cat(
                [best_i, idx[keep]])
        else:
            cd, ci = torch.cat([best_d, d2]), torch.cat([best_i, idx])
            top = torch.argsort(cd, stable=True)[:k]
            best_d, best_i = cd[top], ci[top]
    d = np.sqrt(np.maximum(best_d.cpu().numpy(), 0.0))
    i = best_i.cpu().numpy()
    o = np.lexsort((i, d))
    return i[o], d[o]


def large_g_queries(rng, data, qlen: int):
    """B windows of the large-g collection plus N(0, 0.1) noise."""
    s, n = data.shape
    return [data[a, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
            * 0.1 for a, o in zip(rng.integers(0, s, BATCH),
                                  rng.integers(0, n - qlen + 1, BATCH))]


def check_offset_tiles(torch, coll, data, rng):
    """[21]'s bit-for-bit check: at g = 49 (where one block takes a row)
    the long-row entries with a forced offset tile of LARGE_G_FORCED_T
    against the untiled long-row entries, on B = 8 rows 64 of `coll`,
    qlen 256: the ED contract entry's d2, the ED k-NN chunk entry's pools
    after the partials merge and its counters over two chunks, the ED
    range entry's dense d2 and counters, the LB_Keogh contract entry's
    (lb2, mu, sd), and the LB k-NN and range chunk entries' outputs,
    survivor sets and counters.  Returns the record."""
    from repro_torch.core import planner
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed_chunk_long, fused_gather_ed_long,
        fused_gather_ed_range_long, fused_gather_lb_keogh_chunk_long,
        fused_gather_lb_keogh_long, fused_gather_lb_keogh_range_long)
    from repro_torch.kernels.pool_merge import pool_merge_partials
    dev = coll.data.device
    s, n = coll.data.shape
    g, rows, qlen, t = 49, 64, 256, LARGE_G_FORCED_T
    n_pad = 2 * rows
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    sids = torch.from_numpy(rng.integers(0, s, (BATCH, n_pad)).astype(
        np.int32)).to(dev)
    anc = torch.from_numpy(rng.integers(0, n - qlen - g + 2, (
        BATCH, n_pad)).astype(np.int32)).to(dev)
    nm = torch.from_numpy(rng.integers(1, g + 1, (BATCH, n_pad)).astype(
        np.int32)).to(dev)
    lbs2 = torch.from_numpy(np.sort(rng.random((BATCH, n_pad)), 1).astype(
        np.float32) * 40).to(dev)
    plan = (sids, anc, nm, lbs2)
    q = torch.from_numpy(np.stack(large_g_queries(rng, data, qlen))).to(dev)
    qn, dlo, dhi, _, _ = planner.prepare_query_batch(q, 16, True, "dtw", 25)
    flat = (sids[:, :rows].reshape(-1).contiguous(),
            anc[:, :rows].reshape(-1).contiguous())
    check_equal(torch, "tiled ED contract",
                fused_gather_ed_long(*a0, *flat, qn, g=g, rows=rows,
                                     znorm=True, otile=t),
                fused_gather_ed_long(*a0, *flat, qn, g=g, rows=rows,
                                     znorm=True))
    pools = [[torch.full((BATCH, K), float("inf"), device=dev),
              torch.full((BATCH, K), -1, dtype=torch.int32, device=dev),
              torch.full((BATCH, K), -1, dtype=torch.int32, device=dev)]
             for _ in range(2)]
    sts = [torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
           for _ in range(2)]
    for i in range(2):
        for pool, st, extra in zip(pools, sts, ({}, {"otile": t})):
            part = fused_gather_ed_chunk_long(
                *a0, *plan, qn, pool[0], st, i=i, chunk=rows, g=g,
                znorm=True, **extra)
            pool_merge_partials(pool, part)
        for x, y in zip(pools[0], pools[1]):
            check_equal(torch, "tiled ED chunk pool", y, x)
        check_equal(torch, "tiled ED chunk counters", sts[1], sts[0])
    eps2 = pools[0][0][:, -1].contiguous()
    ovf = torch.full((BATCH,), 2, dtype=torch.int32, device=dev)
    for i in range(2):
        st = [torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
              for _ in range(2)]
        outs = [fused_gather_ed_range_long(
            *a0, *plan, qn, eps2, ovf, st[j], i=i, chunk=rows, g=g,
            znorm=True, **extra) for j, extra in enumerate(({},
                                                           {"otile": t}))]
        check_equal(torch, "tiled ED range d2", outs[1], outs[0])
        check_equal(torch, "tiled ED range counters", st[1], st[0])
    for x, y in zip(fused_gather_lb_keogh_long(*a0, *flat, dlo, dhi, g=g,
                                               rows=rows, znorm=True),
                    fused_gather_lb_keogh_long(*a0, *flat, dlo, dhi, g=g,
                                               rows=rows, znorm=True,
                                               otile=t)):
        check_equal(torch, "tiled LB contract", y, x)
    survivors = 0
    for entry, tail in ((fused_gather_lb_keogh_chunk_long,
                         (pools[0][0],)),
                        (fused_gather_lb_keogh_range_long, (eps2, ovf))):
        for i in range(2):
            st = [torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
                  for _ in range(2)]
            a, z = (entry(*a0, *plan, dlo, dhi, *tail, st[j], i=i,
                          chunk=rows, g=g, znorm=True, **extra)
                    for j, extra in enumerate(({}, {"otile": t})))
            for j in (0, 1, 2, 4, 6, 7):
                check_equal(torch, f"tiled {entry.__name__} output {j}",
                            z[j], a[j])
            check_equal(torch, f"tiled {entry.__name__} counters", st[1],
                        st[0])
            for b in range(BATCH):
                m = int(a[4][b])
                check_equal(torch, "tiled survivor list",
                            z[3][b, :m].sort().values,
                            a[3][b, :m].sort().values)
                survivors += m
    return {"g": g, "forced_otile": t, "rows": rows, "qlen": qlen,
            "survivors": survivors, "bit_equal": True}


def large_g_phase(torch, dev, seed, timings, zero_counts, read_counts):
    """[21], P5 on the card: an index of LARGE_G_SERIES random walks of
    LARGE_G_LEN points at gamma LARGE_G["gamma"] (g = 20,480, past the g
    one block of a row takes: 18,688 ED, 13,760 LB_Keogh), searched on
    the device backend through the offset-tiled long-row entries: ED and
    DTW (r = 10% of |Q|) k-NN and eps-range, B = 8 at qlen 128 and 256,
    counters around each (the tiled entries launched, the staged ones
    not); every answer held to a float64 brute force on the card
    (`brute64_ed`, `brute64_ed_within`, the LB-pruned `brute64_dtw_lb`),
    DTW also to the host backend on LARGE_G_HOST queries a length.  Then
    the tiled entries against their plain versions at g = 20,480, a
    forced small tile bit for bit against the untiled entries at g = 49
    (`check_offset_tiles`), and the tiled k-NN chunk entries timed at
    qlen 256 beside their bound.  Returns (record, launches)."""
    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine, planner)
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed, fused_gather_ed_chunk, fused_gather_ed_range,
        fused_gather_lb_keogh, fused_gather_lb_keogh_chunk, offset_tile)
    lp = EnvelopeParams(**LARGE_G)
    g = lp.gamma + 1
    rng = np.random.default_rng(seed + 21)
    data = np.cumsum(rng.normal(size=(LARGE_G_SERIES, LARGE_G_LEN)),
                     -1).astype(np.float32)
    coll = Collection.from_array(data, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    engine = UlisseEngine.from_collection(coll, lp, device=dev)
    torch.cuda.synchronize()
    rec = {"series": LARGE_G_SERIES, "series_len": LARGE_G_LEN,
           "params": LARGE_G, "g": g,
           "build_s": time.perf_counter() - t0,
           "build_launches": read_counts(("envelope_znorm",)),
           "envelopes": engine.index.num_envelopes,
           "offset_tiles": {f"{m} {ql}": offset_tile(m, ql, g)
                            for m in ("ed", "dtw")
                            for ql in LARGE_G_QLENS}}
    for key, t in rec["offset_tiles"].items():
        if not t < g:
            raise AssertionError(f"[21] {key}: g = {g} is not offset-tiled")
    log(f"[21] large-g index: {LARGE_G_SERIES} x {LARGE_G_LEN} (lmin "
        f"{lp.lmin}, lmax {lp.lmax}, gamma {lp.gamma}: g {g}) -> "
        f"{rec['envelopes']} envelopes in {rec['build_s']:.2f} s; offset "
        f"tiles {rec['offset_tiles']}")
    launches = {}
    knn_names = {"ed": ("fused_gather_ed_chunk_long", "pool_merge_partials"),
                 "dtw": ("fused_gather_lb_keogh_chunk_long", "dtw_survivors",
                         "pool_merge")}
    staged = {"ed": "fused_gather_ed_chunk", "dtw":
              "fused_gather_lb_keogh_chunk"}
    range_names = {"ed": ("fused_gather_ed_range_long", "range_append"),
                   "dtw": ("fused_gather_lb_keogh_range_long",
                           "dtw_survivors", "range_append")}
    answers = {}
    for qlen in LARGE_G_QLENS:
        r = qlen // 10
        qs = large_g_queries(rng, data, qlen)
        n_off = LARGE_G_LEN - qlen + 1
        for measure in ("ed", "dtw"):
            spec = QuerySpec(k=K, measure=measure, r=r)
            zero_counts()
            t0 = time.perf_counter()
            got = engine.search(qs, spec)
            wall = time.perf_counter() - t0
            cnt = read_counts(knn_names[measure] + (staged[measure],))
            if any(cnt[nm] <= 0 for nm in knn_names[measure]) \
                    or cnt[staged[measure]]:
                raise AssertionError(f"[21] {measure} k-NN at qlen {qlen} "
                                     f"did not run the tiled entries: {cnt}")
            for nm in knn_names[measure]:
                launches[nm] = launches.get(nm, 0) + cnt[nm]
            check_answers(got, K)
            worst = 0.0
            if measure == "ed":
                oracle = brute64_ed(torch, coll.data, qs, K, lp.znorm)
            else:
                oracle = []
                for q in qs:
                    i64, d64 = brute64_dtw_lb(torch, coll.data, q, r,
                                              lp.znorm, k=K)
                    oracle.append((i64 // n_off, i64 % n_off, d64))
            own64 = (dtw64_many(torch, coll.data, [
                (q, res.series, res.offsets) for res, q in zip(got, qs)],
                r, lp.znorm) if measure == "dtw" else [None] * len(got))
            for res, own, (ser, off, d) in zip(got, own64, oracle):
                # ED: the same windows (float64 rescores); DTW (float32
                # distances): the brute force's distances, and each
                # reported window's own float64 DP distance
                if measure == "ed" and set(zip(
                        res.series.tolist(), res.offsets.tolist())) != set(
                        zip(ser.tolist(), off.tolist())):
                    raise AssertionError(
                        f"[21] ED qlen {qlen}: answers "
                        f"{list(zip(res.series, res.offsets))} vs the "
                        f"float64 brute force {list(zip(ser, off))}")
                worst = max(worst, float(np.abs(res.dists - d).max()))
                if own is not None:
                    worst = max(worst, float(np.abs(res.dists - own).max()))
            if worst > 5e-3:
                raise AssertionError(f"[21] {measure} qlen {qlen}: "
                                     f"distances off float64 by {worst}")
            host_err = None
            if measure == "dtw":
                host = engine.search(qs[:LARGE_G_HOST], QuerySpec(
                    k=K, measure="dtw", r=r, scan_backend="host",
                    chunk_size=16))
                host_err = max(same_answers(a, b, 5e-3, "[21] DTW vs host")
                               for a, b in zip(got, host))
            answers[(measure, qlen)] = (qs, got)
            rec[f"{measure}_knn_{qlen}"] = {
                "r": r, "wall_s": wall, "queries_per_s": len(qs) / wall,
                "launches": cnt, "max_abs_err_vs_float64": worst,
                "max_abs_err_vs_host": host_err}
            log(f"[21] {measure} k-NN qlen {qlen}"
                + (f" r {r}" if measure == "dtw" else "")
                + f": {len(qs)} queries in {wall:.2f} s; launches {cnt}; "
                f"answers = the float64 brute force (max |d - d64| "
                f"{worst:.2e})" + ("" if host_err is None else
                                   f" and the host backend's"))
            # eps-range just past the batch's least k-th distance (a few
            # hits a query: these smooth long traces give some queries
            # millions of windows within the median k-th)
            eps = 1.02 * float(min(a.dists[-1] for a in got))
            zero_counts()
            t0 = time.perf_counter()
            rgot = engine.search(qs, QuerySpec(eps=eps, measure=measure,
                                               r=r))
            rwall = time.perf_counter() - t0
            rc = read_counts(range_names[measure])
            if any(v <= 0 for v in rc.values()):
                raise AssertionError(f"[21] {measure} range at qlen {qlen} "
                                     f"did not run the tiled entries: {rc}")
            band = (ed_band(qlen, eps, float(np.abs(data).max()))
                    if measure == "ed" else RANGE_BAND)
            hits = edge = 0
            for res, q in zip(rgot, qs):
                if measure == "ed":
                    i64, d64 = brute64_ed_within(torch, coll.data, q,
                                                 lp.znorm, eps + band)
                else:
                    i64, d64 = brute64_dtw_lb(torch, coll.data, q, r,
                                              lp.znorm, radius=eps + band)
                h, e = range_set_check(res, i64, d64, eps, n_off,
                                       f"[21] {measure} range", band)
                hits, edge = hits + h, edge + e
            if measure == "dtw":
                hgot = engine.search(qs[:LARGE_G_HOST], QuerySpec(
                    eps=eps, measure="dtw", r=r, scan_backend="host",
                    chunk_size=16))
                odds = [sorted(set(zip(res.series.tolist(),
                                       res.offsets.tolist()))
                               ^ set(zip(hres.series.tolist(),
                                         hres.offsets.tolist())))
                        for res, hres in zip(rgot, hgot)]
                for d_odd in dtw64_many(torch, coll.data, [
                        (q, [x[0] for x in odd], [x[1] for x in odd])
                        for q, odd in zip(qs, odds)], r, lp.znorm):
                    if (np.abs(d_odd - eps) > RANGE_BAND).any():
                        raise AssertionError("[21] DTW range: device and "
                                             "host hits differ off eps")
            rec[f"{measure}_range_{qlen}"] = {
                "eps": eps, "wall_s": rwall, "launches": rc, "hits": hits,
                "boundary_windows": edge,
                "overflows": sum(x.stats.range_overflows for x in rgot)}
            log(f"[21] {measure} range qlen {qlen}: eps {eps:.4f}, "
                f"{len(qs)} queries in {rwall:.2f} s; launches {rc}; "
                f"{hits} hits = the float64 brute force's ({edge} within "
                f"{band:.3g} of eps)")

    # the tiled entries against their plain versions at g = 20,480 (B =
    # 8, LARGE_G_ROWS rows a chunk, two chunks of envelope rows, every
    # bound 0; the k-NN cut the batch's final pool, range's its k-th)
    index = engine.index
    env = index.envelopes
    qlen = LARGE_G_QLENS[-1]
    rows = LARGE_G_ROWS
    n_pad = 2 * rows
    real = torch.nonzero(env.n_master > 0)[:, 0]
    pick = real[torch.from_numpy(rng.integers(0, real.numel(), (
        BATCH, n_pad))).to(dev)]
    plan = (env.series_id[pick].contiguous(), env.anchor[pick].contiguous(),
            env.n_master[pick].contiguous(),
            torch.zeros((BATCH, n_pad), device=dev))
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    kernel = {}
    for measure in ("ed", "dtw"):
        qs, got = answers[(measure, qlen)]
        r = qlen // 10
        q = torch.from_numpy(np.stack(qs)).to(dev)
        qn, dlo, dhi, _, _ = planner.prepare_query_batch(
            q, lp.seg_len, lp.znorm, measure, r)
        # the cut: the batch's final k-NN distances
        pool_d2 = torch.from_numpy(np.stack([a.dists ** 2 for a in got])
                                   .astype(np.float32)).to(dev)
        if measure == "ed":
            flat = (plan[0][:, :rows].reshape(-1).contiguous(),
                    plan[1][:, :rows].reshape(-1).contiguous())
            kernel["ed_contract_err"] = check_close(
                torch, "fused_gather_ed", fused_gather_ed(
                    *a0, *flat, qn, g=g, rows=rows, znorm=True),
                ref.fused_gather_ed_ref(*a0, *flat, qn, g=g, rows=rows,
                                        znorm=True), scale=2 * qlen)
            pool = [pool_d2.clone(),
                    torch.zeros((BATCH, K), dtype=torch.int32, device=dev),
                    torch.zeros((BATCH, K), dtype=torch.int32, device=dev)]
            plain = [t.clone() for t in pool]
            st = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
            st_p = torch.zeros_like(st)
            for i in range(2):
                ed_step_pair(torch, a0, plan, qn, pool, plain, st, st_p, i,
                             rows, g, True)
            eps2 = pool_d2[:, -1].contiguous()
            ovf = torch.full((BATCH,), 2, dtype=torch.int32, device=dev)
            for i in range(2):
                cols = slice(i * rows, (i + 1) * rows)
                dist = fused_gather_ed(
                    *a0, plan[0][:, cols].reshape(-1).contiguous(),
                    plan[1][:, cols].reshape(-1).contiguous(), qn, g=g,
                    rows=rows, znorm=True)
                st_r = torch.zeros((BATCH, 6), dtype=torch.int32,
                                   device=dev)
                st_rp = torch.zeros_like(st_r)
                check_equal(torch, "[21] ED range entry",
                            fused_gather_ed_range(
                                *a0, *plan, qn, eps2, ovf, st_r, i=i,
                                chunk=rows, g=g, znorm=True),
                            ref.fused_gather_ed_range_ref(
                                *a0, *plan, qn, eps2, ovf, st_rp, i=i,
                                chunk=rows, g=g, znorm=True, dist=dist))
                check_equal(torch, "[21] ED range counters", st_r, st_rp)
            call = [lambda i=i: fused_gather_ed_chunk(
                *a0, *plan, qn, pool_d2, st, i=i, chunk=rows, g=g,
                znorm=True) for i in range(2)]
            plain_call = [lambda i=i: ref.fused_gather_ed_chunk_ref(
                *a0, *plan, qn, pool_d2, st.clone(), i=i, chunk=rows, g=g,
                znorm=True) for i in range(2)]
            nbytes, ops, n_ok = ed_chunk_work(torch, coll, plan, pool_d2,
                                              qlen, rows, g, 2, long=True)
            shape = f"B={BATCH} rows={rows} qlen={qlen} g={g} ok/call={n_ok:.0f}"
            timings[("fused_gather_ed_chunk_long_tiled", qlen, rows)] = \
                timing(torch, call, plain_call, nbytes, ops,
                       kernel["ed_contract_err"], shape)
        else:
            flat = (plan[0][:, :rows].reshape(-1).contiguous(),
                    plan[1][:, :rows].reshape(-1).contiguous())
            lbc = fused_gather_lb_keogh(*a0, *flat, dlo, dhi, g=g,
                                        rows=rows, znorm=True)
            lbw = ref.fused_gather_lb_keogh_ref(*a0, *flat, dlo, dhi, g=g,
                                                rows=rows, znorm=True)
            kernel["lb_contract_err"] = check_close(
                torch, "fused_gather_lb_keogh", lbc[0], lbw[0])
            check_equal(torch, "[21] LB mu", lbc[1], lbw[1])
            check_equal(torch, "[21] LB sd", lbc[2], lbw[2])
            steps, worst, n_s = [], 0.0, 0
            for i in range(2):
                c = chunk_args(torch, a0, qn, dlo, dhi, plan, i, rows,
                               pool_d2, g)
                err, ns_ = check_chunk_entry(torch, c[0], c[1], c[2], c[3])
                worst, n_s = max(worst, err), n_s + ns_
                steps.append(c)
            eps2 = pool_d2[:, -1].contiguous()
            ovf = torch.full((BATCH,), 2, dtype=torch.int32, device=dev)
            for i in range(2):
                c = chunk_args(torch, a0, qn, dlo, dhi, plan, i, rows, eps2,
                               g, ovf=ovf)
                err, ns_ = check_chunk_entry(torch, c[0], c[1], c[2], c[3],
                                             range_mode=True)
                worst = max(worst, err)
            kernel["lb_chunk_err"], kernel["lb_survivors"] = worst, n_s
            call = [lambda c=c: fused_gather_lb_keogh_chunk(
                *c[0], c[3], **c[1]) for c in steps]
            plain_call = [lambda c=c: ref.fused_gather_lb_keogh_chunk_ref(
                *c[0], c[3].clone(), **c[1]) for c in steps]
            per_call = sum(int(c[2][4].sum()) for c in steps) / len(steps)
            nbytes, ops, n_ok = lb_chunk_work(torch, coll, plan, pool_d2,
                                              qlen, rows, g, 2, per_call)
            shape = (f"B={BATCH} rows={rows} qlen={qlen} g={g} ok/call="
                     f"{n_ok:.0f} surv/call={per_call:.0f}")
            timings[("fused_gather_lb_keogh_chunk_long_tiled", qlen,
                     rows)] = timing(torch, call, plain_call, nbytes, ops,
                                     worst, shape, events=2)
    rec["kernels_vs_plain"] = kernel
    rec["forced_tile"] = check_offset_tiles(torch, coll, data, rng)
    for name in ("fused_gather_ed_chunk_long_tiled",
                 "fused_gather_lb_keogh_chunk_long_tiled"):
        t = timings[(name, qlen, rows)]
        log(f"[21] {name:40s} {t['shape']:54s} kernel {t['ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ({t['bound_by']}), plain "
            f"{t['plain_ms']:.3f}")
    log(f"[21] the tiled entries equal their plain versions at g {g} (ED "
        f"contract max abs err {kernel['ed_contract_err']:.2e}, LB lb2 "
        f"{kernel['lb_chunk_err']:.2e}; the ED chunk step, the range entry, "
        f"mu, sd, ids and counters bit for bit), and at g 49 a forced tile "
        f"of {LARGE_G_FORCED_T} equals the untiled entries bit for bit")
    del engine, index, env, coll
    torch.cuda.empty_cache()
    return rec, launches


# -- [22] rank grids and the training collectives -----------------------------

def grid_rank(rank, world, tmp, npy, params, bp, cases, train):
    """One rank of [22]'s gloo world of 4, every rank on cuda:0: a 2 x 2
    DeviceMesh ("data", "model"); engines over the collection at `npy` at
    axes ("data", "model") (4 shards) and ("data",) (2 shards, each held
    by 2 replicas) with the breakpoints `bp`, `cases` searched on each;
    each engine saved and its save opened under the other grid's axes
    (the save's own axes win: cold) and, the 2-shard save, on the whole
    group as a one-axis grid of 4 (re-sharded); then the training
    collectives on this rank's slices of `train`.  Pickles its records to
    `tmp`."""
    import os
    import pickle
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import EnvelopeParams, QuerySpec, UlisseEngine
    from repro_torch.distributed import collectives as c
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    out = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        data = np.load(npy, mmap_mode="r")
        p = EnvelopeParams(**params)

        def answers(e):
            return {n: [(a.dists, a.series, a.offsets, a.stats.as_dict())
                        for a in e.search(qs, QuerySpec(**kw))]
                    for n, (qs, kw) in cases.items()}

        def info(e):
            s = e._shard
            return (s.shards, s.rank, s.replica, s.sections is not None)
        grids = {"dm": ("data", "model"), "d": ("data",)}
        for label, axes in grids.items():
            dist.barrier()
            t = time.perf_counter()
            eng = UlisseEngine.distributed(mesh, p, data, breakpoints=bp,
                                           axes=axes)
            build_s = time.perf_counter() - t
            t = time.perf_counter()
            got = answers(eng)
            out[label] = {"build_s": build_s, "info": info(eng),
                          "search_s": time.perf_counter() - t,
                          "answers": got}
            eng.save(os.path.join(tmp, label))
            del eng
            torch.cuda.empty_cache()
        for label, other in (("dm", "d"), ("d", "dm")):
            dist.barrier()
            t = time.perf_counter()
            eng = UlisseEngine.open(os.path.join(tmp, label), mesh=mesh,
                                    axes=grids[other])
            open_s = time.perf_counter() - t
            out[f"{label}>{other}"] = {"open_s": open_s, "info": info(eng),
                                       "answers": answers(eng)}
            del eng
        dist.barrier()
        t = time.perf_counter()
        eng = UlisseEngine.open(os.path.join(tmp, "d"),
                                mesh=dist.group.WORLD)
        out["d>world"] = {"open_s": time.perf_counter() - t,
                          "info": info(eng), "answers": answers(eng)}
        del eng
        torch.cuda.empty_cache()
        dev = torch.device("cuda", 0)
        x = torch.from_numpy(train["x"][rank]).to(dev)
        err = torch.from_numpy(train["err"][rank]).to(dev)
        red, new = c.ef_int8_allreduce(x, err)
        grads = {k: torch.from_numpy(v).to(dev)
                 for k, v in train["grads"].items()}
        tg = c.make_compressed_grad_transform(mesh)(grads)
        m = train["xm"].shape[0] // world
        y = c.ring_allgather_matmul(
            torch.from_numpy(np.ascontiguousarray(
                train["xm"][rank * m:(rank + 1) * m])).to(dev),
            torch.from_numpy(train["w"]).to(dev))
        out["train"] = {"ef": red.cpu().numpy(), "err": new.cpu().numpy(),
                        "grads": {k: v.cpu().numpy() for k, v in tg.items()},
                        "ring": y.cpu().numpy()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def train_inputs(seed, world: int):
    """The training collectives' inputs for a world: x and err (world,
    m), replicated grads, xm (world * 6, 16) and w (16, 8)."""
    rng = np.random.default_rng(seed + world)
    return {"x": rng.normal(size=(world, 4096)).astype(np.float32),
            "err": (rng.normal(size=(world, 4096)) * 0.01).astype(
                np.float32),
            "grads": {"w": rng.normal(size=(64, 32)).astype(np.float32),
                      "b": rng.normal(size=(32,)).astype(np.float32)},
            "xm": rng.normal(size=(world * 6, 16)).astype(np.float32),
            "w": rng.normal(size=(16, 8)).astype(np.float32)}


def check_train(got, inp, what: str) -> dict:
    """A rank's training collectives against a plain computation: the
    error feedback bit for bit (y - round(y / s) s, numpy float32, the
    reference's quantizer), the mean within rtol 1e-6 of the plain mean
    of the dequantized values, each gradient leaf (every rank the same
    grads: its own quantization), and the ring's product within rtol 1e-6
    / atol 1e-6 of its largest entry against xm @ w."""
    def deq(y):
        s = np.float32(max(np.abs(y).max(), np.float32(1e-8)) / np.float32(
            127.0))
        qv = np.clip(np.round(y / s), -127, 127).astype(np.float32)
        return qv * s
    y = inp["x"] + inp["err"]
    d = np.stack([deq(row) for row in y])
    rank = got["rank"]
    if not np.array_equal(got["err"], y[rank] - d[rank]):
        raise AssertionError(f"[22] {what}: error feedback differs")
    np.testing.assert_allclose(got["ef"], d.mean(0), rtol=1e-6, atol=1e-7,
                               err_msg=f"[22] {what}: ef_int8_allreduce")
    for k, v in got["grads"].items():
        np.testing.assert_allclose(v, deq(inp["grads"][k]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"[22] {what}: {k}")
    want = inp["xm"] @ inp["w"]
    np.testing.assert_allclose(got["ring"], want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(),
                               err_msg=f"[22] {what}: ring matmul")
    return {"max_ef_err": float(np.abs(got["ef"] - d.mean(0)).max())}


def grid_phase(torch, engine, data, p, batches, dtw_batches, dtw_specs,
               seed):
    """[22], rank grids and the training collectives on the card: the
    first GRID_SERIES series of [3]'s collection served by
    `UlisseEngine.distributed` over a 2 x 2 DeviceMesh in a gloo world of
    4 (every rank on cuda:0) at axes ("data", "model") and ("data",),
    [4]'s second ED batch and [8]'s second DTW batch on each, held to a
    local engine over the same series and breakpoints (the same (sid,
    off) in order, ED within 1e-9, DTW rtol 1e-4) and across ranks; each
    grid's save opened under the other grid and the 2-shard save
    re-sharded on the whole group (answers equal the fresh engine's);
    the training collectives in that gloo world of 4 and in an NCCL world
    of 1 (this process) against a plain computation.  Returns its
    record."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.analysis.audit import world_of_one
    from repro_torch.core import Collection, QuerySpec, UlisseEngine
    from repro_torch.distributed import collectives as c
    dev = engine.device
    sub = np.ascontiguousarray(data[:GRID_SERIES])
    bp = engine.index.breakpoints.cpu().numpy()
    cases = {"ed": (batches[1], dict(k=K)),
             "dtw": (dtw_batches[1], dict(k=K, measure="dtw",
                                          r=dtw_specs[1].r))}
    t0 = time.perf_counter()
    local = UlisseEngine.from_collection(
        Collection.from_array(sub, device=dev), p, breakpoints=torch.from_numpy(
            bp).to(dev), device=dev)
    want = {n: local.search(qs, QuerySpec(**kw))
            for n, (qs, kw) in cases.items()}
    local_s = time.perf_counter() - t0
    del local
    torch.cuda.empty_cache()
    train4 = train_inputs(seed, 4)
    rec = {"series": GRID_SERIES, "local_s": local_s}
    with tempfile.TemporaryDirectory() as tmp:
        npy = f"{tmp}/grid.npy"
        np.save(npy, sub)
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            grid_rank, args=(4, tmp, npy, BENCH, bp, cases, train4),
            nprocs=4, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.01)):
                if time.monotonic() > deadline:
                    raise AssertionError("[22] the grid world did not end")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        ranks = []
        for r in range(4):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        rec["world_s"] = time.perf_counter() - t0
    expect = {"dm": lambda r: (4, r, 0, False),
              "d": lambda r: (2, r // 2, r % 2, False),
              "dm>d": lambda r: (4, r, 0, True),
              "d>dm": lambda r: (2, r // 2, r % 2, True),
              "d>world": lambda r: (4, r, 0, False)}
    for r, out in enumerate(ranks):
        for label, info in expect.items():
            if tuple(out[label]["info"]) != info(r):
                raise AssertionError(f"[22] rank {r} {label}: shard "
                                     f"{out[label]['info']} != {info(r)}")
            for n, got in out[label]["answers"].items():
                for j, (a, w) in enumerate(zip(got, want[n])):
                    _same_knn(a, w, cases[n][1].get("measure", "ed"),
                              f"[22] rank {r} {label} {n} q{j}")
        out["train"]["rank"] = r
        check_train(out["train"], train4, f"gloo world 4 rank {r}")
    rec["grids"] = {label: {"build_s": ranks[0][label].get("build_s"),
                            "search_s": ranks[0][label].get("search_s"),
                            "open_s": ranks[0][label].get("open_s"),
                            "info": [o[label]["info"] for o in ranks]}
                    for label in expect}
    train1 = train_inputs(seed, 1)
    with world_of_one(dev):
        x = torch.from_numpy(train1["x"][0]).to(dev)
        e = torch.from_numpy(train1["err"][0]).to(dev)
        red, new = c.ef_int8_allreduce(x, e)
        tg = c.make_compressed_grad_transform()(
            {k: torch.from_numpy(v).to(dev)
             for k, v in train1["grads"].items()})
        y = c.ring_allgather_matmul(torch.from_numpy(train1["xm"]).to(dev),
                                    torch.from_numpy(train1["w"]).to(dev))
        backend = str(torch.distributed.get_backend())
        check_train({"rank": 0, "ef": red.cpu().numpy(),
                     "err": new.cpu().numpy(),
                     "grads": {k: v.cpu().numpy() for k, v in tg.items()},
                     "ring": y.cpu().numpy()}, train1,
                    f"{backend} world 1")
    rec["train"] = {"gloo_world": 4, "nccl_world": 1, "backend_1": backend}
    g = rec["grids"]
    log(f"[22] a 2 x 2 grid over gloo (4 ranks on cuda:0), {GRID_SERIES} "
        f"series: axes (data, model) 4 shards built in "
        f"{g['dm']['build_s']:.2f} s, searched in {g['dm']['search_s']:.2f}"
        f" s; axes (data,) 2 shards x 2 replicas built in "
        f"{g['d']['build_s']:.2f} s, searched in {g['d']['search_s']:.2f} "
        f"s; each grid's save opened under the other (cold: "
        f"{g['dm>d']['open_s']:.2f} / {g['d>dm']['open_s']:.2f} s) and "
        f"the 2-shard save re-sharded on the group "
        f"({g['d>world']['open_s']:.2f} s): every rank's ED and DTW "
        f"answers = the local engine's; the training collectives in the "
        f"gloo world of 4 and a {backend} world of 1 = a plain "
        f"computation; world {rec['world_s']:.1f} s")
    return rec


# -- [23] the host-sync budget and the examples -------------------------------

def audit_examples_phase(torch, engine, data, p, seed):
    """[23]: the host-sync audit (`repro_torch.analysis.audit`) on the
    card under `torch.cuda.set_sync_debug_mode`, its local paths on [3]'s
    engine at qlen 160 (B = 1 and 8), the delta, paged and sharded paths
    on the audit's small engines in an NCCL world of 1 (this process):
    every count equal to the port's own counters, nothing over budget but
    the accepted paged excess; then each example (`examples/*_torch.py`)
    once at its default size, the serving one in a world of 1, each
    checking itself against the brute force.  Returns its record."""
    import os
    from repro_torch.analysis import audit
    t0 = time.perf_counter()
    rows = audit.audit_host_sync(engine.device, batches=(1, BATCH),
                                 local=engine, local_data=data,
                                 local_qlen=QLENS[0])
    bad = audit.findings(rows)
    if bad:
        raise AssertionError(f"[23] over the host-sync budget: {bad}")
    for row in rows:
        if not row["accepted"] and row["syncs"] != sum(
                row["counters"].values()):
            raise AssertionError(f"[23] {row['path']} b{row['b']}: "
                                 f"{row['syncs']} syncs under the debug "
                                 f"mode, the port counts {row['counters']}")
    audit_s = time.perf_counter() - t0
    for row in rows:
        log(f"[23] R2 {row['path']:24s} b={row['b']:<2d} syncs "
            f"{row['syncs']:4d} = port {row['counters']}"
            + (" (accepted excess)" if row["accepted"] else ""))
    rec = {"audit": [{k: v for k, v in row.items() if k != "sites"}
                     for row in rows], "audit_s": audit_s, "examples": {}}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for name, ok_line in (("quickstart_torch", "quickstart OK"),
                          ("dedup_pipeline_torch", "dedup OK"),
                          ("serve_ulisse_torch", "serve OK")):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                  f"{name}.py")],
                             capture_output=True, text=True, env=env,
                             timeout=600, cwd=str(ROOT))
        wall = time.perf_counter() - t0
        if out.returncode != 0 or ok_line not in out.stdout:
            raise AssertionError(f"[23] {name} failed ({out.returncode}): "
                                 f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
        rec["examples"][name] = {"wall_s": wall,
                                 "last": out.stdout.strip().splitlines()[-1]}
        log(f"[23] examples/{name}.py at its default size: {wall:.1f} s, "
            f"{rec['examples'][name]['last']}")
    log(f"[23] host-sync audit: {len(rows)} path runs in {audit_s:.1f} s, "
        f"every count under the sync debug mode = the port's own counters "
        f"(paged: the accepted excess)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=FULL_SERIES,
                    help="series in the collection (at most 1,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full results as JSON here")
    args = ap.parse_args()
    if not 1 <= args.series <= FULL_SERIES:
        ap.error(f"--series must be in [1, {FULL_SERIES}]")

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine, build_index, executor,
                                  planner)
    from repro_torch.core.search import brute_force_knn
    from repro_torch.core.paa import znormalize
    from repro_torch.core import envelope as core_envelope
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batch_ed import batch_ed
    from repro_torch.kernels.dtw_band import (dtw_band, dtw_band_wide,
                                              dtw_survivors,
                                              dtw_survivors_wide)
    from repro_torch.kernels.envelope import envelope_plan, envelope_znorm
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed, fused_gather_ed_chunk, fused_gather_ed_chunk_long,
        fused_gather_ed_long, fused_gather_ed_range,
        fused_gather_ed_range_long, fused_gather_lb_keogh,
        fused_gather_lb_keogh_chunk, fused_gather_lb_keogh_chunk_long,
        fused_gather_lb_keogh_long, fused_gather_lb_keogh_range,
        fused_gather_lb_keogh_range_long, gather_znorm)
    from repro_torch.kernels import fused_verify as fused_verify_mod
    from repro_torch.kernels.lb_keogh import lb_keogh
    from repro_torch.kernels.mindist import mindist_paa, mindist_sym
    from repro_torch.kernels.pool_merge import pool_merge, pool_merge_partials
    from repro_torch.kernels.range_append import range_append
    from repro_torch.train.data import series_batches

    # the plain versions' products stay full float32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    # the main path's kernels: the ED chunk entry and the partials merge
    # every chunk step, the lower bounds once a batch
    wrappers = {"fused_gather_ed_chunk": fused_gather_ed_chunk,
                "pool_merge_partials": pool_merge_partials,
                "mindist_sym": mindist_sym, "mindist_paa": mindist_paa}
    # every kernel wrapper of the port, each count set to 0 before a path
    all_wrappers = {**wrappers, "fused_gather_ed": fused_gather_ed,
                    "pool_merge": pool_merge,
                    "fused_gather_lb_keogh": fused_gather_lb_keogh,
                    "fused_gather_lb_keogh_chunk": fused_gather_lb_keogh_chunk,
                    "gather_znorm": gather_znorm,
                    "dtw_survivors": dtw_survivors, "dtw_band": dtw_band,
                    "dtw_survivors_wide": dtw_survivors_wide,
                    "dtw_band_wide": dtw_band_wide,
                    "envelope_znorm": envelope_znorm, "batch_ed": batch_ed,
                    "lb_keogh": lb_keogh,
                    "fused_gather_ed_long": fused_gather_ed_long,
                    "fused_gather_ed_chunk_long": fused_gather_ed_chunk_long,
                    "fused_gather_lb_keogh_long": fused_gather_lb_keogh_long,
                    "fused_gather_lb_keogh_chunk_long":
                        fused_gather_lb_keogh_chunk_long,
                    "fused_gather_ed_range": fused_gather_ed_range,
                    "fused_gather_ed_range_long": fused_gather_ed_range_long,
                    "fused_gather_lb_keogh_range": fused_gather_lb_keogh_range,
                    "fused_gather_lb_keogh_range_long":
                        fused_gather_lb_keogh_range_long,
                    "range_append": range_append}

    def zero_counts():
        torch.cuda.synchronize()
        for w in all_wrappers.values():
            w.launches = 0
        executor.device_exact_scan.syncs = 0
        executor.to_host.syncs = 0

    def read_counts(names):
        return {name: all_wrappers[name].launches for name in names}
    results = {"card": card, "series": args.series, "params": BENCH}
    # each phase's seconds, on a line of its own as it ends
    phase_s = results["phase_s"] = {}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        log(f"[{name}] phase seconds: {phase_s[name]:.1f}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_all()
    results["build_s"] = time.perf_counter() - t0
    log(f"[1] kernels built in {results['build_s']:.1f} s")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}.cu: {line.strip()}")

    phase_done("1")

    # -- 2. kernels against their plain versions, main-path shapes --------
    p = EnvelopeParams(**BENCH)
    g = p.gamma + 1
    n_env = args.series * p.num_envelopes(SERIES_LEN)
    n_pad_env = -(-n_env // 64 ** 2) * 64 ** 2
    errs = {name: 0.0 for name in ("fused_gather_ed", "mindist_sym",
                                   "mindist_paa", "pool_merge",
                                   "pool_merge_dense")}
    rng = np.random.default_rng(args.seed + 1)
    probe = Collection.from_array(
        rng.normal(size=(4096, SERIES_LEN)).astype(np.float32) * 2 + 1,
        device=dev)
    for rows in (64, 512):
        for qlen in QLENS:
            sids = torch.from_numpy(rng.integers(
                0, 4096, BATCH * rows).astype(np.int32)).to(dev)
            anc = torch.from_numpy(rng.integers(
                0, SERIES_LEN - qlen + 1, BATCH * rows).astype(np.int32)
            ).to(dev)
            qs = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
                np.float32)).to(dev)
            for znorm in (True, False):
                a = (probe.data, probe.csum, probe.csum2, probe.csum_lo,
                     probe.csum2_lo, probe.center, sids, anc, qs)
                got = fused_gather_ed(*a, g=g, rows=rows, znorm=znorm)
                want = ref.fused_gather_ed_ref(*a, g=g, rows=rows,
                                               znorm=znorm)
                errs["fused_gather_ed"] = max(
                    errs["fused_gather_ed"],
                    check_close(torch, "fused_gather_ed", got, want))
    lo = torch.randn((n_pad_env, p.w), device=dev)
    hi = lo + torch.rand((n_pad_env, p.w), device=dev)
    lo[:7, 0], hi[:7, 0] = -float("inf"), float("inf")
    valid = torch.rand(n_pad_env, device=dev) > 0.01
    bp = torch.sort(torch.randn(p.card - 1, device=dev)).values
    sym_lo = torch.searchsorted(bp, lo, right=True).to(torch.int32)
    sym_hi = torch.searchsorted(bp, hi, right=True).to(torch.int32)
    qp = torch.randn((BATCH, p.w), device=dev)
    nb = n_pad_env // 64
    # a point query (ED) and a true interval (q_hi > q_lo), so that a
    # kernel mixing up the two query bounds cannot pass
    for qh in (qp, qp + torch.rand((BATCH, p.w), device=dev)):
        for nseg in (10, 16):
            errs["mindist_sym"] = max(errs["mindist_sym"], check_close(
                torch, "mindist_sym",
                mindist_sym(qp, qh, sym_lo, sym_hi, bp, valid, p.seg_len,
                            nseg),
                ref.mindist_sym_ref(qp, qh, sym_lo, sym_hi, bp, valid,
                                    p.seg_len, nseg)))
            errs["mindist_paa"] = max(errs["mindist_paa"], check_close(
                torch, "mindist_paa",
                mindist_paa(qp, qh, lo[:nb], hi[:nb], valid[:nb],
                            p.seg_len, nseg),
                ref.mindist_ref(qp, qh, lo[:nb], hi[:nb], valid[:nb],
                                p.seg_len, nseg)))
    results["ed_steps_bit_equal"] = check_ed_step(torch, dev, probe, rng, g)
    dtw_errs, results["lb_keogh_mu_sd_bit_equal"], (w_differ, w_points) = \
        check_dtw_kernels(torch, dev, p, probe, rng)
    results["znorm_w_differ_from_divide"] = {"points": w_points,
                                             "differ": w_differ}
    if w_differ:
        raise AssertionError(
            f"the kernels' window normalization differs from the IEEE "
            f"divide at {w_differ} of {w_points} points")
    errs.update(dtw_errs)
    del lo, hi, valid, sym_lo, sym_hi
    for part in (check_slice3_kernels(torch, dev, p, probe, rng),
                 check_wide_kernels(torch, dev, rng),
                 check_long_kernels(torch, dev, rng, g)):
        for name, err in part.items():
            errs[name] = max(errs.get(name, 0.0), err)
    del probe
    torch.cuda.synchronize()
    log(f"[2] kernels agree with their plain versions: "
        + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items())
        + f"; LB_Keogh mu/sd bit-equal to the plain version's: "
        f"{results['lb_keogh_mu_sd_bit_equal']:.6f}; the LB and DP "
        f"kernels' normalized window points differing from the IEEE "
        f"divide: {w_differ} of {w_points}; the ED chunk entry + partials "
        f"merge and the dense merge bit-equal to the plain step and the "
        f"stable-sort merge over {results['ed_steps_bit_equal']} steps "
        f"(pools and counters); the wide DP entries bit-equal to the warp "
        f"entries at W = 1023; past the staged kernels (ED qlen "
        f"{LONG_CHECK['ed'][0]}, LB qlen {LONG_CHECK['dtw'][0]}) the "
        f"long-row variants hold their plain versions (the ED step and "
        f"the LB mu/sd bit for bit) and equal the staged kernels bit for "
        f"bit at qlen {LONG_CHECK['ed'][1]}; mindist at nseg "
        f"{LQ_ED // LQ['seg_len']} and 6000, and the build past its "
        f"staging, hold theirs")

    phase_done("2")

    # -- 3. the index on the card ------------------------------------------
    t0 = time.perf_counter()
    data = series_batches(args.series, SERIES_LEN, seed=args.seed)
    t_series = time.perf_counter()
    coll = Collection.from_array(data, device=dev)
    zero_counts()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = UlisseEngine.from_collection(coll, p, block_size=64,
                                          num_levels=2, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    build_launches = read_counts(("envelope_znorm",))
    if build_launches["envelope_znorm"] <= 0:
        raise AssertionError("the index build did not launch envelope_znorm")
    index = engine.index
    results["index"] = {
        "data_s": t1 - t0, "series_batches_s": t_series - t0,
        "from_array_s": t1 - t_series, "build_s": t2 - t1,
        "envelopes": index.num_envelopes,
        "valid_envelopes": int(index.envelopes.valid.sum()),
        "blocks": [lvl.size for lvl in index.levels],
        "launches": build_launches,
        "peak_build_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "resident_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    log(f"[3] index: {args.series} series x {SERIES_LEN} -> "
        f"{results['index']['envelopes']} envelopes, blocks "
        f"{results['index']['blocks']}; data+stats {t1 - t0:.1f} s "
        f"(series_batches {t_series - t0:.1f} s, Collection.from_array "
        f"{t1 - t_series:.1f} s), build {t2 - t1:.3f} s, peak "
        f"{results['index']['peak_build_gib']:.2f} GiB; launches "
        f"{build_launches}")
    tb = time.perf_counter()
    built = check_build_envelopes(torch, coll, index, p)
    results["index"]["build_vs_plain"] = built
    if built["differ"] or not built["checked"]:
        raise AssertionError(
            f"the build's envelopes differ from the plain version at "
            f"{built['differ']} of {built['checked']} elements")
    log(f"[3] every envelope of the build equals the plain version "
        f"computed on the card block by block: {built['differ']} of "
        f"{built['checked']} (lo, hi) elements differ, {built['blocks']} "
        f"blocks, {time.perf_counter() - tb:.1f} s")

    phase_done("3")

    # -- 4. the main path --------------------------------------------------
    qrng = np.random.default_rng(args.seed + 2)

    def make_batch(qlen):
        sids = qrng.integers(0, args.series, BATCH)
        offs = qrng.integers(0, SERIES_LEN - qlen + 1, BATCH)
        return [data[s, o:o + qlen] + qrng.normal(size=qlen).astype(
            np.float32) * 0.1 for s, o in zip(sids, offs)]

    # its own query stream, so the paths' batches stay those of earlier runs
    lrng = np.random.default_rng(args.seed + 3)
    lb_excess = check_lower_bounds(
        torch, index, coll.data, p,
        [data[s, o:o + qlen] + lrng.normal(size=qlen).astype(np.float32)
         * 0.1 for qlen in QLENS
         for s, o in zip(lrng.integers(0, args.series, 2),
                         lrng.integers(0, SERIES_LEN - qlen + 1, 2))],
        4096, args.seed)
    results["index"]["lower_bound_max_excess"] = lb_excess
    log(f"[3] lower bounds never exceed the true distance on 4096 sampled "
        f"envelopes x 4 queries (iSAX and PAA; max lb - d {lb_excess:.3g},"
        f" slack 1e-4)")

    spec = QuerySpec(k=K)
    engine.search(make_batch(QLENS[0]), spec)        # warm-up (host copy)
    batches = [make_batch(QLENS[i % len(QLENS)]) for i in range(BATCHES)]
    zero_counts()
    answers, lat = [], []
    t0 = time.perf_counter()
    for qs in batches:
        tb = time.perf_counter()
        answers.append(engine.search(qs, spec))
        lat.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    stop_syncs = executor.device_exact_scan.syncs
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    nq = sum(len(b) for b in batches)
    flat = [r for ans in answers for r in ans]
    check_answers(flat, K)
    st = [r.stats for r in flat]
    results["main_path"] = {
        "queries": nq, "batches": len(batches), "wall_s": wall,
        "queries_per_s": nq / wall, "batch_latency_s": lat,
        "launches": launches, "stop_test_syncs": stop_syncs,
        "host_syncs_per_batch": stop_syncs / len(batches) + 1,
        "stop_test_every": executor.STOP_TEST_EVERY,
        "mean_chunks_visited": float(np.mean([s.chunks_visited for s in st])),
        "mean_envelopes_checked": float(np.mean(
            [s.envelopes_checked for s in st])),
        "mean_true_dists": float(np.mean(
            [s.true_dist_computations for s in st])),
        "mean_pruning_power": float(np.mean([s.pruning_power for s in st])),
        "exact_from_approx": float(np.mean(
            [s.exact_from_approx for s in st]))}
    log(f"[4] main path: {nq} queries in {len(batches)} batches, "
        f"{nq / wall:.1f} queries/s; launches {launches}; host syncs per "
        f"batch {results['main_path']['host_syncs_per_batch']:.2f} (stop "
        f"test every {executor.STOP_TEST_EVERY} chunks + 1 readback); mean "
        f"chunks {results['main_path']['mean_chunks_visited']:.1f}, "
        f"pruning power {results['main_path']['mean_pruning_power']:.5f}")

    phase_done("4")

    # -- 5. answers against the brute force on the card ---------------------
    worst = 0.0
    for ans, qs in ((answers[0], batches[0]), (answers[1], batches[1])):
        for r, q in list(zip(ans, qs))[:2]:
            oracle = brute_force_knn(coll, q, k=K, znorm=p.znorm)
            err = float(np.abs(r.dists - oracle.dists).max())
            worst = max(worst, err)
            if err > 5e-3:
                raise AssertionError(
                    f"engine {r.dists} vs brute force {oracle.dists}")
    results["brute_force_max_abs_err"] = worst
    log(f"[5] engine answers match the brute force on the card (4 queries,"
        f" max |d - d_brute| {worst:.2e}, tolerance 5e-3)")

    phase_done("5")

    # -- 6. kernel timings at main-path inputs -------------------------------
    env = index.envelopes
    fine = index.levels[-1]
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) or L2_BYTES
    # enough copies of each kernel's envelope intervals that a round of
    # calls streams twice the L2 through it, so every call reads from HBM
    # (mindist_paa_env: the PAA entry over every envelope, as a spec with
    # use_paa_bounds runs it)
    env_ins = {"mindist_sym": (env.sym_lo, env.sym_hi, env.valid),
               "mindist_paa": (fine.paa_lo, fine.paa_hi, fine.valid),
               "mindist_paa_env": (env.paa_lo, env.paa_hi, env.valid)}
    for name, ins in env_ins.items():
        in_bytes = sum(t.numel() * t.element_size() for t in ins)
        env_ins[name] = [ins] + [tuple(t.clone() for t in ins)
                                 for _ in range(-(-2 * l2 // in_bytes) - 1)]
    kernels, timings = [], {}
    for qlen in QLENS:
        nseg = p.query_segments(qlen)
        qlist = make_batch(qlen)
        q = torch.from_numpy(np.stack(qlist)).to(dev)
        qs, _, _, qb, qh = planner.prepare_query_batch(q, p.seg_len,
                                                       p.znorm)
        bpt = index.breakpoints
        for name, n_rows in (("mindist_sym", env.size),
                             ("mindist_paa", fine.size),
                             ("mindist_paa_env", env.size)):
            ins = env_ins[name]
            if name == "mindist_sym":
                call = [lambda c=c: mindist_sym(qb, qh, c[0], c[1], bpt,
                                                c[2], p.seg_len, nseg)
                        for c in ins]
                plain = [lambda c=c: ref.mindist_sym_ref(
                    qb, qh, c[0], c[1], bpt, c[2], p.seg_len, nseg)
                    for c in ins]
            else:
                call = [lambda c=c: mindist_paa(qb, qh, *c, p.seg_len, nseg)
                        for c in ins]
                plain = [lambda c=c: ref.mindist_ref(qb, qh, *c, p.seg_len,
                                                     nseg) for c in ins]
            got, want = call[0](), plain[0]()
            err = check_close(torch, name.replace("_env", ""), got, want)
            # both kernels sum in the plain version's order: bit for bit
            check_equal(torch, f"{name} at qlen {qlen}", got, want)
            del got, want
            nbytes = (2 * n_rows * nseg * 4 + n_rows + BATCH * n_rows * 4
                      + 2 * BATCH * nseg * 4 + (p.card - 1) * 4)
            ops = 7 * BATCH * n_rows * nseg
            timings[(name, qlen)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} N={n_rows} nseg={nseg} x{len(ins)}")
        # the exact scan's and the approximate pass's real chunk inputs
        lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                             p.seg_len, nseg, False)
        n_pad = executor.pow2ceil(env.size)
        none = torch.full((BATCH, 1), env.size, dtype=torch.int32,
                          device=dev)
        zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
        ssids, sanc, snm, slbs2, _ = planner.device_scan_pack(
            env.series_id, env.anchor, env.n_master, lbs, none, zero,
            chunk=1, n_pad=n_pad)
        blk = planner.block_lower_bounds_batch(qb, qh, fine.paa_lo,
                                               fine.paa_hi, fine.valid,
                                               p.seg_len, nseg)
        asids, aanc, *_ = planner.device_leaf_pack(
            env.series_id, env.anchor, env.n_master, env.valid, blk,
            n_main=env.size, block_size=64, chunk=64, n_leaves=8)
        for rows, s_all, a_all in ((512, ssids, sanc), (64, asids, aanc)):
            chunks = [(s_all[:, i * rows:(i + 1) * rows].reshape(-1)
                       .contiguous(),
                       a_all[:, i * rows:(i + 1) * rows].reshape(-1)
                       .contiguous()) for i in range(8)]
            a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo,
                  coll.csum2_lo, coll.center)
            call = [lambda c=c: fused_gather_ed(*a0, c[0], c[1], qs, g=g,
                                                rows=rows, znorm=p.znorm)
                    for c in chunks]
            plain = [lambda c=c: ref.fused_gather_ed_ref(
                *a0, c[0], c[1], qs, g=g, rows=rows, znorm=p.znorm)
                for c in chunks]
            err = check_close(torch, "fused_gather_ed", call[0](),
                              plain[0]())
            # bytes this input needs: distinct region elements, distinct
            # prefix-sum positions (x4 arrays), queries, plan, output
            nbytes = (gather_bytes(torch, coll, *chunks[0], qlen, g)
                      + BATCH * qlen * 4 + BATCH * rows * 8
                      + BATCH * rows * g * 4)
            ops = 2 * BATCH * rows * g * qlen
            timings[("fused_gather_ed", qlen, rows)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} rows={rows} qlen={qlen} g={g}")
        # the scan's chunk entry and the partials merge over the exact
        # scan's first 8 chunks, under this batch's final pool (what the
        # bulk of the scan sees: every query active, most rows kept)
        ans = engine.search(qlist, spec)
        pool0 = [torch.from_numpy(np.stack([a.dists ** 2 for a in ans])
                                  .astype(np.float32)).to(dev),
                 *(torch.from_numpy(np.stack([getattr(a, f) for a in ans])
                                    .astype(np.int32)).to(dev)
                   for f in ("series", "offsets"))]
        plan = (ssids, sanc, snm, slbs2)
        rows = 512
        st_k = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
        st_p = torch.zeros_like(st_k)
        ed_step_pair(torch, a0, plan, qs, [t.clone() for t in pool0],
                     [t.clone() for t in pool0], st_k, st_p, 0, rows, g,
                     p.znorm)
        call = [lambda i=i: fused_gather_ed_chunk(
            *a0, *plan, qs, pool0[0], st_k, i=i, chunk=rows, g=g,
            znorm=p.znorm) for i in range(8)]
        plain = [lambda i=i: ref.fused_gather_ed_chunk_ref(
            *a0, *plan, qs, pool0[0], st_p, i=i, chunk=rows, g=g,
            znorm=p.znorm) for i in range(8)]
        nbytes, ops, n_ok = ed_chunk_work(torch, coll, plan, pool0[0], qlen,
                                          rows, g, 8)
        timings[("fused_gather_ed_chunk", qlen, rows)] = timing(
            torch, call, plain, nbytes, ops, 0.0,
            f"B={BATCH} rows={rows} qlen={qlen} ok/call={n_ok:.0f}")
        parts = [c() for c in call]
        pools = [[t.clone() for t in pool0] for _ in parts]
        call = [lambda a=a, q=q: pool_merge_partials(q, a)
                for a, q in zip(parts, pools)]
        plain = [lambda a=a: ref.pool_merge_partials_ref(pool0, a)
                 for a in parts]
        cat = [torch.cat([pool0[0], a[0].view(torch.float32)], dim=1)
               for a in parts]
        library = [lambda c=c: torch.topk(c, K, dim=1, largest=False)
                   for c in cat]
        nbytes, live = merge_work(torch, pool0[0],
                                  parts[0][0].view(torch.float32))
        timings[("pool_merge", qlen)] = timing(
            torch, call, plain, nbytes, 0, 0.0,
            f"B={BATCH} k={K} P={parts[0].shape[2]} live={live}",
            library=library)
        del parts, pools, cat
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    for key, t in timings.items():
        lib = (f"  library {t['library_ms']:.4f} ms"
               if t["library_ms"] is not None else "")
        log(f"[6] {key[0]:21s} {t['shape']:38s} kernel {t['ms']:.4f} ms  "
            f"plain {t['plain_ms']:.4f} ms{lib}  bound {t['bound_ms']:.5f} "
            f"ms ({t['bound_by']}, {t['timer']}/{t['plain_timer']}; events "
            f"{t['event_ms']:.4f} / {t['plain_event_ms']:.4f} ms)")

    phase_done("6")

    # -- 7. where a batch's time goes (one traced batch) -------------------
    zero_counts()
    tr = trace_batch(torch, engine, batches[1], spec)
    steps = fused_gather_ed_chunk.launches
    tr["chunk_steps"] = steps
    tr["device_events_per_step"] = tr["device_events"] / max(steps, 1)
    tr["launch_calls_per_step"] = tr["launch_calls"] / max(steps, 1)
    tr["sort_kernel_events"] = sort_events(tr)
    results["traced_batch"] = tr
    log_trace(7, tr)
    log(f"[7] {steps} chunk steps: {tr['device_events_per_step']:.2f} device"
        f" activities and {tr['launch_calls_per_step']:.2f} kernel launch "
        f"calls a step; sort kernels: {tr['sort_kernel_events']}")
    # the scan loop alone, traced: at most 4 kernel launch calls a chunk
    # step and no sort kernel (the batch's sorts are the planner's LB
    # order, once a batch)
    sc = trace_scan(torch, coll, index, p, batches[1], spec)
    results["traced_scan"] = sc
    log(f"[7] the exact scan alone (qlen {sc['qlen']}, no approximate "
        f"seed): {sc['chunk_steps']} chunk steps, "
        f"{sc['launch_calls_per_step']:.2f} kernel launch calls and "
        f"{sc['device_events_per_step']:.2f} device activities a step, "
        f"device busy {sc['device_busy_s']:.4f} s of {sc['wall_s']:.4f} s; "
        f"sort kernels: {sc['sort_kernel_events']}")
    if sc["launch_calls_per_step"] > 4:
        raise AssertionError("the ED scan makes more than 4 kernel launch "
                             "calls a chunk step")
    if sc["sort_kernel_events"]:
        raise AssertionError("the ED scan runs a sort kernel")

    phase_done("7")

    # -- 8. the DTW path -----------------------------------------------------
    dtw_wrappers = {"fused_gather_lb_keogh_chunk": fused_gather_lb_keogh_chunk,
                    "dtw_survivors": dtw_survivors, "pool_merge": pool_merge,
                    "mindist_sym": mindist_sym, "mindist_paa": mindist_paa}
    dtw_specs = [QuerySpec(k=K, measure="dtw", r=r) for _, r in DTW_CASES]
    dtw_batches = [make_batch(qlen) for qlen, _ in DTW_CASES]
    zero_counts()
    dtw_answers, dtw_lat = [], []
    t0 = time.perf_counter()
    for qs, dspec in zip(dtw_batches, dtw_specs):
        tb = time.perf_counter()
        dtw_answers.append(engine.search(qs, dspec))
        dtw_lat.append(time.perf_counter() - tb)
    dtw_wall = time.perf_counter() - t0
    dtw_launches = {name: w.launches for name, w in dtw_wrappers.items()}
    dtw_syncs = executor.device_exact_scan.syncs
    for name, n in dtw_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the DTW path")
    if fused_gather_ed_chunk.launches or pool_merge_partials.launches:
        raise AssertionError("the DTW path launched the ED chunk step")
    if dtw_survivors_wide.launches:
        raise AssertionError("the DTW path at r = 16 / 25 launched the wide "
                             "DP entry")
    flat = [r for ans in dtw_answers for r in ans]
    check_answers(flat, K)
    st = [r.stats for r in flat]
    nq = len(flat)
    results["dtw_path"] = {
        "cases": [{"qlen": qlen, "r": r} for qlen, r in DTW_CASES],
        "queries": nq, "batches": len(dtw_batches), "wall_s": dtw_wall,
        "queries_per_s": nq / dtw_wall, "batch_latency_s": dtw_lat,
        "launches": dtw_launches, "stop_test_syncs": dtw_syncs,
        "host_syncs_per_batch": dtw_syncs / len(dtw_batches) + 1,
        "mean_chunks_visited": float(np.mean([s.chunks_visited for s in st])),
        "mean_envelopes_checked": float(np.mean(
            [s.envelopes_checked for s in st])),
        "mean_pruning_power": float(np.mean([s.pruning_power for s in st])),
        "mean_dtw_lb_keogh": float(np.mean([s.dtw_lb_keogh for s in st])),
        "mean_dtw_full": float(np.mean([s.dtw_full for s in st])),
        "mean_abandoning_power": float(np.mean(
            [s.abandoning_power for s in st])),
        "exact_from_approx": float(np.mean(
            [s.exact_from_approx for s in st]))}
    d = results["dtw_path"]
    log(f"[8] DTW path: {nq} queries in {len(dtw_batches)} batches "
        f"({', '.join(f'qlen {q} r {r}' for q, r in DTW_CASES)}), "
        f"{d['queries_per_s']:.2f} queries/s, batch latency "
        f"{', '.join(f'{x:.3f}' for x in dtw_lat)} s; launches "
        f"{dtw_launches}; host syncs per batch "
        f"{d['host_syncs_per_batch']:.2f}; mean chunks "
        f"{d['mean_chunks_visited']:.1f}, pruning power "
        f"{d['mean_pruning_power']:.5f}; LB_Keogh {d['mean_dtw_lb_keogh']:.1f}"
        f" -> DP {d['mean_dtw_full']:.1f} per query, abandoning power "
        f"{d['mean_abandoning_power']:.5f}")
    # the float64 brute force keeps each query's DTW_KEEP nearest windows:
    # [16] holds the range answers of the same queries to them
    worst, checked, brute_s, dtw_oracle = 0.0, 0, {}, {}
    tb = time.perf_counter()
    for (qlen, r), ans, qs in zip(DTW_CASES, dtw_answers, dtw_batches):
        tq = time.perf_counter()
        for j, (res, q) in enumerate(list(zip(ans, qs))[:DTW_BRUTE[qlen]]):
            _, d = dtw_oracle[(qlen, j)] = brute64_dtw_lb(
                torch, coll.data, q, r, p.znorm, k=DTW_KEEP)
            err = float(np.abs(res.dists - d[:K]).max())
            worst, checked = max(worst, err), checked + 1
            if err > 5e-3:
                raise AssertionError(
                    f"DTW engine {res.dists} vs brute force {d[:K]}")
        brute_s[qlen] = (time.perf_counter() - tq) / DTW_BRUTE[qlen]
    results["dtw_brute_force"] = {"queries": checked, "max_abs_err": worst,
                                  "seconds": time.perf_counter() - tb,
                                  "seconds_per_query": brute_s}
    log(f"[8] DTW answers match the float64 DP brute force on the card "
        f"({checked} queries: {DTW_BRUTE}; max |d - d_brute| {worst:.2e}, "
        f"tolerance 5e-3; {time.perf_counter() - tb:.1f} s, per query "
        + ", ".join(f"qlen {q}: {t:.1f} s" for q, t in brute_s.items())
        + ")")

    phase_done("8")

    # -- 9. DTW kernel timings at the DTW path's inputs ----------------------
    n_pad = executor.pow2ceil(env.size)
    none = torch.full((BATCH, 1), env.size, dtype=torch.int32, device=dev)
    zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    rows = 512
    results["lb_le_dtw"] = {}
    for (qlen, r), qs_np, ans in zip(DTW_CASES, dtw_batches, dtw_answers):
        nseg = p.query_segments(qlen)
        q = torch.from_numpy(np.stack(qs_np)).to(dev)
        qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
            q, p.seg_len, p.znorm, "dtw", r)
        lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                             p.seg_len, nseg, False)
        ssids, sanc, snm, slbs2, _ = planner.device_scan_pack(
            env.series_id, env.anchor, env.n_master, lbs, none, zero,
            chunk=1, n_pad=n_pad)
        # the first 24 chunks of the LB order: their regions (~6 MB each)
        # stream more than twice the L2 per round
        chunks = [(ssids[:, i * rows:(i + 1) * rows].contiguous(),
                   sanc[:, i * rows:(i + 1) * rows].contiguous(),
                   snm[:, i * rows:(i + 1) * rows]) for i in range(24)]
        call = [lambda c=c: fused_gather_lb_keogh(
            *a0, c[0].reshape(-1), c[1].reshape(-1), dlo, dhi, g=g,
            rows=rows, znorm=p.znorm) for c in chunks]
        plain = [lambda c=c: ref.fused_gather_lb_keogh_ref(
            *a0, c[0].reshape(-1), c[1].reshape(-1), dlo, dhi, g=g,
            rows=rows, znorm=p.znorm) for c in chunks]
        got, want = call[0](), plain[0]()
        err = check_close(torch, "fused_gather_lb_keogh", got[0], want[0])
        for suffix, x, y in zip((".mu", ".sd"), got[1:], want[1:]):
            check_close(torch, "fused_gather_lb_keogh" + suffix, x, y)
        region_bytes = gather_bytes(torch, coll, chunks[0][0].reshape(-1),
                                    chunks[0][1].reshape(-1), qlen, g)
        nbytes = (region_bytes + 2 * BATCH * qlen * 4 + BATCH * rows * 8
                  + 3 * BATCH * rows * g * 4)
        # per window point: subtract, divide, two subtracts, two max,
        # two multiplies, two adds
        ops = 10 * BATCH * rows * g * qlen
        if qlen == TIMED_QLEN:
            timings[("fused_gather_lb_keogh", qlen, rows)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} rows={rows} qlen={qlen} g={g}")
        # the scan's chunk entry and the DP over its survivors, under the
        # batch's final k-th distance (what the scan's later chunks see)
        # (the plan's chunks 0-23 under a pool whose k-th is the batch's
        # final one: every query active, the rows below it kept)
        kth = torch.tensor([[float(a.dists[-1]) ** 2] for a in ans],
                           dtype=torch.float32, device=dev)
        plan = (ssids, sanc, snm, slbs2)
        steps = [chunk_args(torch, a0, qn, dlo, dhi, plan, i, rows, kth, g,
                            znorm=p.znorm) for i in range(len(chunks))]
        err, _ = check_chunk_entry(torch, *steps[0][:4])
        call = [lambda c=c: fused_gather_lb_keogh_chunk(*c[0], c[3], **c[1])
                for c in steps]
        plain = [lambda c=c: ref.fused_gather_lb_keogh_chunk_ref(
            *c[0], c[3].clone(), **c[1]) for c in steps]
        per_call = sum(int(c[2][4].sum()) for c in steps) / len(steps)
        # its bound: the LB of the ok candidates alone
        c_bytes, c_ops, ok_c = lb_chunk_work(torch, coll, plan, kth, qlen,
                                             rows, g, len(steps), per_call)
        if qlen == TIMED_QLEN:
            timings[("fused_gather_lb_keogh_chunk", qlen, rows)] = timing(
                torch, call, plain, c_bytes, c_ops, err,
                f"B={BATCH} rows={rows} qlen={qlen} g={g} "
                f"ok/call={ok_c:.0f} surv/call={per_call:.0f}", events=2)
        # LB_Keogh <= DTW on every survivor of the first chunk that has
        # any (the LB kernel's bound and the DP kernel's distance, one
        # normalization)
        first = next(c for c in steps if int(c[2][4].sum()) > 0)
        lb2_0, dp0 = first[2][0], first[4]
        d2_0 = dtw_survivors(*dp0[:-1], dp0[-1].clone(), r=r, znorm=p.znorm)
        surv0 = torch.isfinite(d2_0)
        excess = (lb2_0.reshape(BATCH, -1) - d2_0)[surv0]
        worst = float(excess.max()) if excess.numel() else -float("inf")
        bad = int((excess > 0).sum())
        results["lb_le_dtw"][qlen] = {"survivors": int(surv0.sum()),
                                      "lb_above_dtw": bad,
                                      "max_lb_minus_dtw": worst}
        if bad or not excess.numel():
            raise AssertionError(
                f"LB_Keogh <= DTW fails on {bad} of {excess.numel()} "
                f"survivors (qlen {qlen}; max lb - d {worst})")
        log(f"[9] LB_Keogh <= DTW on all {excess.numel()} survivors of a "
            f"chunk (qlen {qlen}, r {r}; max lb - d {worst:.3g})")
        surv_inputs = [c[4] for c in steps[:8]]
        call = [lambda a=a: dtw_survivors(*a, r=r, znorm=p.znorm)
                for a in surv_inputs]
        plain = [lambda a=a: ref.dtw_survivors_ref(*a, r=r, znorm=p.znorm)
                 for a in surv_inputs]
        a_0 = surv_inputs[0]
        err = check_close(
            torch, "dtw_survivors",
            dtw_survivors(*a_0[:-1], a_0[-1].clone(), r=r, znorm=p.znorm),
            ref.dtw_survivors_ref(*a_0[:-1], a_0[-1].clone(), r=r,
                                  znorm=p.znorm))
        # survivor windows, their list entry and four plan entries and
        # their output, queries, counts
        nbytes = (per_call * (qlen * 4 + 6 * 4) + BATCH * qlen * 4
                  + BATCH * 4)
        ops = 5 * per_call * dtw_cells(qlen, r)
        if qlen == TIMED_QLEN:
            timings[("dtw_survivors", qlen)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} M={rows * g} r={r} surv/call={per_call:.0f}")
            timings[("dtw_survivors", qlen)]["survivors_per_call"] = \
                per_call
        # the function entry: q_0 against windows of the collection, more
        # than twice the L2 of them
        cands = znormalize(coll.data[:-(-2 * l2 // (qlen * 4)), :qlen]
                           ).contiguous()
        ncand = cands.shape[0]
        q0 = qn[0].contiguous()
        call = [lambda: dtw_band(q0, cands, r)]
        plain = [lambda: ref.dtw_band_ref(q0, cands, r)]
        err = check_close(torch, "dtw_band", call[0](), plain[0]())
        if qlen == TIMED_QLEN:
            timings[("dtw_band", qlen)] = timing(
                torch, call, plain, ncand * qlen * 4 + qlen * 4 + ncand * 4,
                5 * ncand * dtw_cells(qlen, r), err,
                f"N={ncand} qlen={qlen} r={r}")
        # the dense pool merge of the DP's output over the same 8 chunks,
        # under the batch's final pool
        pool0 = [torch.from_numpy(np.stack([a.dists ** 2 for a in ans])
                                  .astype(np.float32)).to(dev),
                 *(torch.from_numpy(np.stack([getattr(a, f) for a in ans])
                                    .astype(np.int32)).to(dev)
                   for f in ("series", "offsets"))]
        dense = [(dtw_survivors(*a[:-1], a[-1].clone(), r=r, znorm=p.znorm),
                  a[4], a[5]) for a in surv_inputs]
        got = [t.clone() for t in pool0]
        pool_merge(got, *dense[0])
        for name, x, y in zip(("d2", "sid", "off"), got,
                              ref.pool_merge_ref(pool0, *dense[0])):
            check_equal(torch, f"dense pool merge {name}", x, y)
        pools = [[t.clone() for t in pool0] for _ in dense]
        call = [lambda a=a, q=q: pool_merge(q, *a)
                for a, q in zip(dense, pools)]
        plain = [lambda a=a: ref.pool_merge_ref(pool0, *a) for a in dense]
        cat = [torch.cat([pool0[0], a[0]], dim=1) for a in dense]
        library = [lambda c=c: torch.topk(c, K, dim=1, largest=False)
                   for c in cat]
        nbytes, live = merge_work(torch, pool0[0], dense[0][0])
        if qlen == TIMED_QLEN:
            timings[("pool_merge_dense", qlen)] = timing(
                torch, call, plain, nbytes, 0, 0.0,
                f"B={BATCH} k={K} M={rows * g} live={live}",
                library=library, events=2)
        del cands, surv_inputs, chunks, steps, dense, pools, cat
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    for key, t in timings.items():
        if key[0] in ("fused_gather_lb_keogh", "fused_gather_lb_keogh_chunk",
                      "dtw_survivors", "dtw_band", "pool_merge_dense"):
            lib = (f"  library {t['library_ms']:.4f} ms"
                   if t["library_ms"] is not None else "")
            log(f"[9] {key[0]:27s} {t['shape']:45s} kernel {t['ms']:.4f} "
                f"ms  plain {t['plain_ms']:.4f} ms{lib}  bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}, {t['timer']}/"
                f"{t['plain_timer']}; "
                f"events {t['event_ms']:.4f} / {t['plain_event_ms']:.4f} "
                f"ms)")

    phase_done("9")

    # -- 10. where a DTW batch's time goes (one traced batch) ---------------
    zero_counts()
    tr = trace_batch(torch, engine, dtw_batches[1], dtw_specs[1])
    steps = fused_gather_lb_keogh_chunk.launches
    # the survivor pack's cumsum (a scan kernel) is gone from the scan
    tr["scan_kernel_events"] = sum(
        row["count"] for row in tr["device_by_name"]
        if "scan" in row["name"].lower())
    tr["chunk_steps"] = steps
    tr["device_events_per_step"] = tr["device_events"] / max(steps, 1)
    tr["launch_calls_per_step"] = tr["launch_calls"] / max(steps, 1)
    tr["sort_kernel_events"] = sort_events(tr)
    results["traced_dtw_batch"] = tr
    log_trace(10, tr)
    log(f"[10] {steps} chunk steps: {tr['device_events_per_step']:.1f} device"
        f" activities and {tr['launch_calls_per_step']:.1f} kernel launch "
        f"calls a step; scan kernels (the survivor pack's cumsum): "
        f"{tr['scan_kernel_events']}; sort kernels: "
        f"{tr['sort_kernel_events']}")
    if tr["scan_kernel_events"]:
        raise AssertionError("the traced DTW batch still runs scan kernels")
    sc = trace_scan(torch, coll, index, p, dtw_batches[1], dtw_specs[1])
    results["traced_dtw_scan"] = sc
    log(f"[10] the exact DTW scan alone (qlen {sc['qlen']}, no approximate "
        f"seed): {sc['chunk_steps']} chunk steps, "
        f"{sc['launch_calls_per_step']:.2f} kernel launch calls and "
        f"{sc['device_events_per_step']:.2f} device activities a step; "
        f"sort kernels: {sc['sort_kernel_events']}")
    if sc["sort_kernel_events"]:
        raise AssertionError("the DTW scan runs a sort kernel")
    # the LB chunk entry decides, masks and counts itself: a DTW step is
    # the entry, the DP and the dense merge's two kernels (plus the stop
    # test's two launches every STOP_TEST_EVERY steps)
    if sc["launch_calls_per_step"] > 4.5:
        raise AssertionError("the DTW scan makes more than 4.5 kernel launch "
                             "calls a chunk step")

    phase_done("10")

    # -- 11. the host backend ------------------------------------------------
    # one query per measure (qlen 256) whose device answer was checked
    # against the brute force in [5] and [8] (one a measure keeps the
    # script inside its time)
    host_cases = {
        "ed": [(batches[i][0], answers[i][0], QuerySpec(
            k=K, scan_backend="host")) for i in (1,)],
        "dtw": [(dtw_batches[i][0], dtw_answers[i][0], QuerySpec(
            k=K, measure="dtw", r=r, scan_backend="host"))
            for i, (_, r) in enumerate(DTW_CASES) if i == 1]}
    host_kernels = {"ed": ("batch_ed", "mindist_sym", "mindist_paa"),
                    "dtw": ("lb_keogh", "dtw_band", "mindist_sym",
                            "mindist_paa")}
    results["host_path"] = {}
    host_answers = {}
    for measure, cases in host_cases.items():
        zero_counts()
        t0 = time.perf_counter()
        got = [engine.search(q, hspec) for q, _, hspec in cases]
        wall = time.perf_counter() - t0
        hl = read_counts(host_kernels[measure])
        syncs = executor.to_host.syncs
        for name, n in hl.items():
            if n <= 0:
                raise AssertionError(
                    f"{name} was not launched on the host {measure} path")
        worst = max(same_answers(g_, want, 5e-3, f"host {measure}")
                    for g_, (_, want, _) in zip(got, cases))
        host_answers[measure] = got
        results["host_path"][measure] = {
            "queries": len(cases), "qlens": [len(q) for q, _, _ in cases],
            "wall_s": wall, "queries_per_s": len(cases) / wall,
            "launches": hl, "host_syncs": syncs,
            "host_syncs_per_query": syncs / len(cases),
            "chunks_visited": [r.stats.chunks_visited for r in got],
            "max_abs_err_vs_device": worst}
        h = results["host_path"][measure]
        log(f"[11] host backend, {measure}: {len(cases)} queries (qlen "
            f"{h['qlens']}) in {wall:.2f} s, {h['queries_per_s']:.3f} "
            f"queries/s; launches {hl}; host syncs per query "
            f"{h['host_syncs_per_query']:.1f}; chunks {h['chunks_visited']};"
            f" answers = the device's (max |d - d_device| {worst:.2e}, "
            f"tolerance 5e-3)")

    phase_done("11")

    # -- 12. approx-only -----------------------------------------------------
    approx_cases = {
        "ed": (batches[0], answers[0], QuerySpec(k=K, mode="approx"),
               ("fused_gather_ed_chunk", "pool_merge_partials",
                "mindist_paa")),
        "dtw": (dtw_batches[1], dtw_answers[1], QuerySpec(
            k=K, measure="dtw", r=DTW_CASES[1][1], mode="approx"),
            ("fused_gather_lb_keogh_chunk", "dtw_survivors", "pool_merge",
             "mindist_paa"))}
    results["approx_path"] = {}
    for measure, (qs, exact, aspec, names) in approx_cases.items():
        zero_counts()
        t0 = time.perf_counter()
        got = engine.search(qs, aspec)
        wall = time.perf_counter() - t0
        al = read_counts(names)
        for name, n in al.items():
            if n <= 0:
                raise AssertionError(
                    f"{name} was not launched on the approx {measure} path")
        if mindist_sym.launches:
            raise AssertionError("approx-only launched mindist_sym")
        check_answers(got, K)
        certified = 0
        for a, e in zip(got, exact):
            # ED: both rescored in float64; DTW: the same device DP values
            if a.dists[-1] < e.dists[-1] - 1e-6:
                raise AssertionError(f"approx {measure} k-th distance "
                                     f"{a.dists[-1]} < exact {e.dists[-1]}")
            if a.stats.exact_from_approx:
                certified += 1
                same_answers(a, e, 1e-9, f"certified approx {measure}")
        results["approx_path"][measure] = {
            "queries": len(qs), "qlen": len(qs[0]), "wall_s": wall,
            "launches": al, "certified": certified,
            "stop_test_syncs": executor.device_exact_scan.syncs,
            "mean_kth_ratio": float(np.mean(
                [a.dists[-1] / e.dists[-1] for a, e in zip(got, exact)]))}
        ap = results["approx_path"][measure]
        log(f"[12] approx-only, {measure}: {len(qs)} queries (qlen "
            f"{ap['qlen']}) in {wall:.3f} s; launches {al}; stop-test "
            f"syncs {ap['stop_test_syncs']} + 1 readback; certified exact "
            f"{certified}/{len(qs)} (equal to the exact answer); mean "
            f"approx/exact k-th distance {ap['mean_kth_ratio']:.4f}")

    phase_done("12")

    # -- 13. the index build's and the host backend's kernel timings ---------
    n_env1 = p.num_envelopes(SERIES_LEN)
    blk = max(1, core_envelope._BUILD_BLOCK_ELEMS // (n_env1 * g * p.w))
    x = coll.data[:blk]
    xc = x - x.mean(dim=-1, keepdim=True)
    sums = [(core_envelope._prefix(xc), core_envelope._prefix(xc * xc))]
    sums += [tuple(t.clone() for t in sums[0]) for _ in range(
        -(-2 * l2 // (2 * sums[0][0].numel() * 4)) - 1)]
    ekw = dict(lmin=p.lmin, lmax=p.lmax, gamma=p.gamma, seg_len=p.seg_len)
    call = [lambda c=c: envelope_znorm(*c, **ekw) for c in sums]
    plain = [lambda c=c: ref.envelope_znorm_ref(*c, **ekw) for c in sums]
    for k_, c_ in zip(call[0](), plain[0]()):
        check_equal(torch, "envelope_znorm", k_, c_)
    cells, len_pairs, seg_pairs = envelope_work(p, SERIES_LEN)
    # per cell a subtract, a divide, a min and a max; per (master,
    # length) two subtracts, two divides, a multiply, a subtract, two
    # max and a square root; per (master, segment) a subtract and a divide
    timings[("envelope_znorm",)] = timing(
        torch, call, plain,
        blk * (2 * (SERIES_LEN + 1) * 4 + 2 * n_env1 * p.w * 4),
        blk * (4 * cells + 9 * len_pairs + 2 * seg_pairs), 0.0,
        f"S={blk} n={SERIES_LEN} x{len(sums)}")
    timings[("envelope_znorm",)]["cells_per_series"] = cells
    del sums, call, plain, x, xc
    # the same at the card build's own block (one launch of six a build)
    bblk = core_envelope.build_block_series(SERIES_LEN, p, dev)
    x = coll.data[:bblk]
    xc = x - x.mean(dim=-1, keepdim=True)
    sums = (core_envelope._prefix(xc), core_envelope._prefix(xc * xc))
    del x, xc
    timings[("envelope_znorm", "build block")] = timing(
        torch, [lambda: envelope_znorm(*sums, **ekw)],
        [lambda: ref.envelope_znorm_ref(*sums, **ekw)],
        bblk * (2 * (SERIES_LEN + 1) * 4 + 2 * n_env1 * p.w * 4),
        bblk * (4 * cells + 9 * len_pairs + 2 * seg_pairs), 0.0,
        f"S={bblk} n={SERIES_LEN} (a build block)")
    del sums
    # the wide DP entries at qlen 600, r 600 (a band of 1,199 slots)
    wq, wr = LONG_CASE
    wrng = np.random.default_rng(args.seed + 5)
    q_w = torch.from_numpy(wrng.normal(size=wq).astype(np.float32)).to(dev)
    c_w = znormalize(torch.from_numpy(np.cumsum(wrng.normal(
        size=(4_096, wq)), -1).astype(np.float32)).to(dev)).contiguous()
    call = [lambda: dtw_band_wide(q_w, c_w, wr)]
    plain = [lambda: ref.dtw_band_ref(q_w, c_w, wr)]
    err = check_equal(torch, "dtw_band_wide", call[0](), plain[0]())
    timings[("dtw_band_wide", wq)] = timing(
        torch, call, plain, c_w.numel() * 4 + wq * 4 + c_w.shape[0] * 4,
        5 * c_w.shape[0] * dtw_cells(wq, wr), err,
        f"N={c_w.shape[0]} qlen={wq} r={wr}")
    ldata_t = torch.from_numpy(np.cumsum(wrng.normal(
        size=(LONG_SERIES, LONG_LEN)), -1).astype(np.float32)).to(dev)
    # [14]'s build (w 32: the one-pass kernel's two passes of 16) on
    # these random walks
    lp13 = EnvelopeParams(**LONG)
    sums = core_envelope.centered_prefixes(ldata_t)
    lkw = dict(lmin=lp13.lmin, lmax=lp13.lmax, gamma=lp13.gamma,
               seg_len=lp13.seg_len)
    call = [lambda: envelope_znorm(*sums, **lkw)]
    plain = [lambda: ref.envelope_znorm_ref(*sums, **lkw)]
    for k_, c_ in zip(call[0](), plain[0]()):
        check_equal(torch, "envelope_znorm at [14]'s shape", k_, c_)
    cells, len_pairs, seg_pairs = envelope_work(lp13, LONG_LEN)
    n_env14 = lp13.num_envelopes(LONG_LEN)
    l_plan = envelope_plan(LONG_LEN, lp13.lmin, lp13.lmax, lp13.gamma,
                           lp13.seg_len)
    timings[("envelope_znorm", "w32")] = timing(
        torch, call, plain,
        LONG_SERIES * (2 * (LONG_LEN + 1) * 4 + 2 * n_env14 * lp13.w * 4),
        LONG_SERIES * (4 * cells + 9 * len_pairs + 2 * seg_pairs), 0.0,
        f"S={LONG_SERIES} n={LONG_LEN} w={lp13.w} plan={l_plan}")
    del sums, call, plain
    s_args, s_d2 = survivor_inputs(torch, dev, wrng, ldata_t, wq)
    n_surv = int(s_args[3].sum())
    call = [lambda: dtw_survivors_wide(*s_args, s_d2.clone(), r=wr,
                                       znorm=True)]
    plain = [lambda: ref.dtw_survivors_ref(*s_args, s_d2.clone(), r=wr,
                                           znorm=True)]
    err = check_equal(torch, "dtw_survivors_wide", call[0](), plain[0]())
    timings[("dtw_survivors_wide", wq)] = timing(
        torch, call, plain, n_surv * (wq * 4 + 6 * 4) + BATCH * wq * 4
        + BATCH * 4, 5 * n_surv * dtw_cells(wq, wr), err,
        f"B={BATCH} M=512 r={wr} surv={n_surv}")
    # dtw_band_wide at the long-query phase's shape ([15]: qlen 20,000, r
    # 200, a band of one warp streamed past 6,144 points); the plain
    # version's 40,000 diagonals run once, checked and timed
    q_l = torch.from_numpy(wrng.normal(size=LQ_DTW).astype(np.float32)).to(
        dev)
    c_l = znormalize(torch.from_numpy(np.cumsum(wrng.normal(
        size=(LQ_DP_CANDS, LQ_DTW)), -1).astype(np.float32)).to(dev)
                     ).contiguous()
    call = [lambda: dtw_band_wide(q_l, c_l, LQ_R)]
    want, p_ms = timed_call(torch, lambda: ref.dtw_band_ref(q_l, c_l, LQ_R))
    err = check_equal(torch, "dtw_band_wide at [15]'s shape", call[0](),
                      want)
    timings[("dtw_band_wide", LQ_DTW)] = timing(
        torch, call, None, c_l.numel() * 4 + LQ_DTW * 4 + LQ_DP_CANDS * 4,
        5 * LQ_DP_CANDS * dtw_cells(LQ_DTW, LQ_R), err,
        f"N={LQ_DP_CANDS} qlen={LQ_DTW} r={LQ_R}", plain_ms=p_ms)
    del q_l, c_l
    del c_w, ldata_t, s_args, s_d2
    host = executor.host_envelopes(index)
    for qlen, r in DTW_CASES:
        q = (batches[0] if qlen == QLENS[0] else batches[1])[0]
        pq = planner.prepare_query(q, p, "dtw", r, device=dev)
        order, _ = planner.plan_scan_order(index, pq)
        # the windows of the host scan's first 8 chunks (512 envelopes
        # each, ~26 MB at qlen 256): a round streams more than the L2
        chunks = []
        for i in range(8):
            e = order[i * 512:(i + 1) * 512]
            chunks.append(executor.gather_windows(
                coll.data, host["series_id"][e], host["anchor"][e],
                host["n_master"][e], qlen, g)[0])
        nw = chunks[0].shape[0]
        qt = torch.from_numpy(np.stack(
            batches[0] if qlen == QLENS[0] else batches[1])).to(dev)
        qn_all = planner.prepare_query_batch(qt, p.seg_len, True)[0]
        for qb in (1, 8):
            for znorm, qs_t in ((True, qn_all[:qb]), (False, qt[:qb])):
                call = [lambda c=c: batch_ed(c, qs_t, znorm) for c in chunks]
                plain = [lambda c=c: ref.batch_ed_ref(c, qs_t, znorm)
                         for c in chunks]
                err = check_close(torch, "batch_ed", call[0](), plain[0]())
                lib = None if znorm else [
                    lambda c=c: torch.cdist(c, qs_t) ** 2 for c in chunks]
                if qlen == TIMED_QLEN:
                    timings[("batch_ed", qlen, qb,
                             "znorm" if znorm else "raw")] = timing(
                        torch, call, plain,
                        (nw * qlen + qb * qlen + nw * qb) * 4,
                        nw * qlen * (2 * qb + 3), err,
                        f"N={nw} qlen={qlen} Qb={qb} "
                        f"{'znorm' if znorm else 'raw'}", library=lib)
        wns = [znormalize(c) for c in chunks]
        del chunks
        call = [lambda c=c: lb_keogh(pq.dtw_lo, pq.dtw_hi, c) for c in wns]
        plain = [lambda c=c: ref.lb_keogh_ref(pq.dtw_lo, pq.dtw_hi, c)
                 for c in wns]
        err = check_close(torch, "lb_keogh", call[0](), plain[0]())
        # per point two subtracts, two max, two multiplies, two adds
        if qlen == TIMED_QLEN:
            timings[("lb_keogh", qlen)] = timing(
                torch, call, plain, (nw * qlen + 2 * qlen + nw) * 4,
                8 * nw * qlen, err, f"N={nw} qlen={qlen} r={r}")
        del wns
    for key, t in timings.items():
        if key[0] in ("envelope_znorm", "batch_ed", "lb_keogh",
                      "dtw_band_wide", "dtw_survivors_wide") and (
                key[0] != "dtw_survivors_wide" or key[1] != LQ_DTW):
            lib = (f"  library {t['library_ms']:.4f} ms"
                   if t["library_ms"] is not None else "")
            log(f"[13] {key[0]:18s} {t['shape']:34s} kernel {t['ms']:.4f} ms"
                f"  plain {t['plain_ms']:.4f} ms{lib}  bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['timer']}/"
                f"{t['plain_timer']}; events {t['event_ms']:.4f} / "
                f"{t['plain_event_ms']:.4f} ms)")
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}

    phase_done("13")

    # -- 14. the long-query DTW path ----------------------------------------
    lp = EnvelopeParams(**LONG)
    lrng = np.random.default_rng(args.seed + 4)
    ldata = np.cumsum(lrng.normal(size=(LONG_SERIES, LONG_LEN)), -1).astype(
        np.float32)
    lcoll = Collection.from_array(ldata, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    lengine = UlisseEngine.from_collection(lcoll, lp, block_size=16,
                                           num_levels=2, device=dev)
    torch.cuda.synchronize()
    l_build_s = time.perf_counter() - t0
    l_build = read_counts(("envelope_znorm",))
    if l_build["envelope_znorm"] <= 0:
        raise AssertionError("the long DTW index build did not launch "
                             "envelope_znorm")
    log(f"[14] long DTW index: {LONG_SERIES} x {LONG_LEN} (w {lp.w}) built "
        f"on the card in {l_build_s:.3f} s; launches {l_build}")
    lq, lr = LONG_CASE
    long_qs = [ldata[s_, o:o + lq] + lrng.normal(size=lq).astype(np.float32)
               * 0.1 for s_, o in zip(lrng.integers(0, LONG_SERIES, 2),
                                      lrng.integers(0, LONG_LEN - lq + 1, 2))]
    long_kernels = {
        "device": ("fused_gather_lb_keogh_chunk", "dtw_survivors_wide",
                   "pool_merge", "mindist_sym", "mindist_paa"),
        "host": ("lb_keogh", "dtw_band_wide", "mindist_sym", "mindist_paa")}
    results["long_path"] = {"series": LONG_SERIES, "series_len": LONG_LEN,
                            "params": LONG, "qlen": lq, "r": lr,
                            "build_s": l_build_s,
                            "build_launches": l_build}
    for backend, names in long_kernels.items():
        qs_b = long_qs if backend == "device" else long_qs[:1]
        zero_counts()
        t0 = time.perf_counter()
        got = lengine.search(qs_b, QuerySpec(k=K, measure="dtw", r=lr,
                                             scan_backend=backend))
        wall = time.perf_counter() - t0
        ll = read_counts(names + ("dtw_survivors", "dtw_band"))
        for name in names:
            if ll[name] <= 0:
                raise AssertionError(f"{name} was not launched on the long "
                                     f"DTW path ({backend})")
        if ll["dtw_survivors"] or ll["dtw_band"]:
            raise AssertionError("the long DTW path launched a warp DP entry")
        check_answers(got, K)
        worst = 0.0
        for res, q in zip(got, qs_b):
            series, offs, dists = brute64_dtw(torch, lcoll.data, q, K, lr,
                                              lp.znorm)
            if set(zip(res.series.tolist(), res.offsets.tolist())) != set(
                    zip(series.tolist(), offs.tolist())):
                raise AssertionError(
                    f"long DTW ({backend}) answers {res.series, res.offsets}"
                    f" vs float64 brute force {series, offs}")
            worst = max(worst, float(np.abs(res.dists - dists).max()))
        if worst > 5e-3:
            raise AssertionError(f"long DTW ({backend}) distances off the "
                                 f"float64 brute force by {worst}")
        st = [r_.stats for r_ in got]
        results["long_path"][backend] = {
            "queries": len(qs_b), "wall_s": wall, "launches": ll,
            "max_abs_err_vs_float64": worst,
            "mean_dtw_lb_keogh": float(np.mean([x.dtw_lb_keogh for x in st])),
            "mean_dtw_full": float(np.mean([x.dtw_full for x in st]))}
        log(f"[14] long DTW path, {backend} backend: {len(qs_b)} queries of "
            f"qlen {lq} at r {lr} on {LONG_SERIES} x {LONG_LEN} in "
            f"{wall:.2f} s; launches {ll}; LB_Keogh "
            f"{results['long_path'][backend]['mean_dtw_lb_keogh']:.1f} -> DP "
            f"{results['long_path'][backend]['mean_dtw_full']:.1f} per "
            f"query; answers = the float64 brute force (max |d - d64| "
            f"{worst:.2e})")
    del lengine, lcoll

    phase_done("14")

    # -- 15. the long-query path ----------------------------------------------
    # an index whose build passes the card build's old staging, queried
    # past the staged chunk entries and past 736 segments
    qp = EnvelopeParams(**LQ)
    lq_rng = np.random.default_rng(args.seed + 6)
    qdata = np.cumsum(lq_rng.normal(size=(LQ_SERIES, LQ_LEN)), -1).astype(
        np.float32)
    qcoll = Collection.from_array(qdata, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    qengine = UlisseEngine.from_collection(qcoll, qp, block_size=16,
                                           num_levels=2, device=dev)
    torch.cuda.synchronize()
    lq_build_s = time.perf_counter() - t0
    lq_build = read_counts(("envelope_znorm",))
    if lq_build["envelope_znorm"] <= 0:
        raise AssertionError("the long index build did not launch "
                             "envelope_znorm")
    lq = results["long_query_path"] = {
        "series": LQ_SERIES, "series_len": LQ_LEN, "params": LQ,
        "build_s": lq_build_s, "build_launches": lq_build,
        "envelopes": qengine.index.num_envelopes}
    log(f"[15] long index: {LQ_SERIES} x {LQ_LEN} (lmin {LQ['lmin']}, lmax "
        f"{LQ['lmax']}, seg_len {LQ['seg_len']}) -> {lq['envelopes']} "
        f"envelopes, built on the card in {lq_build_s:.2f} s; launches "
        f"{lq_build}")
    lq_cases = (
        ("ed", LQ_ED, QuerySpec(k=K),
         ("fused_gather_ed_chunk_long", "pool_merge_partials", "mindist_sym",
          "mindist_paa"), ("fused_gather_ed_chunk",)),
        ("dtw", LQ_DTW, QuerySpec(k=K, measure="dtw", r=LQ_R),
         ("fused_gather_lb_keogh_chunk_long", "dtw_survivors_wide",
          "pool_merge", "mindist_sym", "mindist_paa"),
         ("fused_gather_lb_keogh_chunk", "dtw_survivors")))
    lq_queries = {}
    for measure, qlen, lspec, names, staged_names in lq_cases:
        qs_l = [qdata[s_, o:o + qlen] + lq_rng.normal(size=qlen).astype(
            np.float32) * 0.1 for s_, o in zip(
            lq_rng.integers(0, LQ_SERIES, BATCH),
            lq_rng.integers(0, LQ_LEN - qlen + 1, BATCH))]
        lq_queries[measure] = qs_l
        zero_counts()
        t0 = time.perf_counter()
        got = qengine.search(qs_l, lspec)
        wall = time.perf_counter() - t0
        ll = read_counts(names + staged_names)
        for name in names:
            if ll[name] <= 0:
                raise AssertionError(f"{name} was not launched on the long "
                                     f"{measure} path")
        for name in staged_names:
            if ll[name]:
                raise AssertionError(f"the long {measure} path launched the "
                                     f"staged {name}")
        check_answers(got, K)
        worst, host_err, host_wall = 0.0, None, None
        if measure == "ed":
            # the port's brute force on the card, in float64
            for res, (series, offs, dists) in zip(got, brute64_ed(
                    torch, qcoll.data, qs_l, K, qp.znorm)):
                if set(zip(res.series.tolist(), res.offsets.tolist())) != \
                        set(zip(series.tolist(), offs.tolist())):
                    raise AssertionError(
                        f"long ED answers {res.series, res.offsets} vs the "
                        f"float64 brute force {series, offs}")
                worst = max(worst, float(np.abs(res.dists - dists).max()))
        else:
            # the host backend's answers, and a float64 DP of every
            # reported window
            zero_counts()
            t1 = time.perf_counter()
            host = qengine.search(qs_l, QuerySpec(
                k=K, measure="dtw", r=LQ_R, scan_backend="host"))
            host_wall = time.perf_counter() - t1
            lq["dtw_host_launches"] = read_counts(("dtw_band_wide",
                                                   "dtw_band", "lb_keogh"))
            if lq["dtw_host_launches"]["dtw_band_wide"] <= 0 or \
                    lq["dtw_host_launches"]["dtw_band"]:
                raise AssertionError("the long host DTW query did not run "
                                     "its DP through dtw_band_wide")
            host_err = max(same_answers(a, b, 5e-3, "long DTW device vs host")
                           for a, b in zip(got, host))
            for res, d64 in zip(got, dtw64_many(
                    torch, qcoll.data, [(q, res.series, res.offsets)
                                        for res, q in zip(got, qs_l)],
                    LQ_R, qp.znorm)):
                worst = max(worst, float(np.abs(res.dists - d64).max()))
        if worst > 5e-3:
            raise AssertionError(f"long {measure} distances off float64 by "
                                 f"{worst}")
        # eps-range at this length, through the range entries' long-row
        # variants: eps just past the batch's median K-th neighbour; ED
        # held to a float64 brute force, DTW to the host backend (the two
        # sets may differ only at windows whose float64 DP distance lies
        # within RANGE_BAND of eps)
        eps_l = 1.02 * float(np.median([a.dists[-1] for a in got]))
        rname = ("fused_gather_ed_range_long" if measure == "ed"
                 else "fused_gather_lb_keogh_range_long")
        zero_counts()
        t1 = time.perf_counter()
        rgot = qengine.search(qs_l, QuerySpec(eps=eps_l, measure=measure,
                                              r=lspec.r))
        range_wall = time.perf_counter() - t1
        rl = read_counts((rname, rname[:-5], "range_append"))
        if rl[rname] <= 0 or rl["range_append"] <= 0:
            raise AssertionError(f"the long {measure} range path did not "
                                 f"launch {rname} and range_append")
        if rl[rname[:-5]]:
            raise AssertionError(f"the long {measure} range path launched "
                                 f"the staged {rname[:-5]}")
        n_off_l = LQ_LEN - qlen + 1
        r_hits, r_edge = 0, 0
        band_l = ed_band(qlen, eps_l) if measure == "ed" else RANGE_BAND
        if measure == "ed":
            for res, q in zip(rgot, qs_l):
                i64, d64 = brute64_ed_within(torch, qcoll.data, q, qp.znorm,
                                             eps_l + band_l)
                h, e = range_set_check(res, i64, d64, eps_l, n_off_l,
                                       "long ED range", band_l)
                r_hits, r_edge = r_hits + h, r_edge + e
        else:
            hgot = qengine.search(qs_l, QuerySpec(
                eps=eps_l, measure="dtw", r=LQ_R, scan_backend="host"))
            # the windows in one hit set only, and every device hit, in
            # one float64 DP
            odds, jobs = [], []
            for res, hres, q in zip(rgot, hgot, qs_l):
                a_ = set(zip(res.series.tolist(), res.offsets.tolist()))
                b_ = set(zip(hres.series.tolist(), hres.offsets.tolist()))
                odd = sorted(a_ ^ b_)
                odds.append(odd)
                jobs += [(q, [x[0] for x in odd], [x[1] for x in odd]),
                         (q, res.series, res.offsets)]
                r_hits, r_edge = r_hits + len(a_), r_edge + len(odd)
            d64s = dtw64_many(torch, qcoll.data, jobs, LQ_R, qp.znorm)
            for j, res in enumerate(rgot):
                d_odd, d_dev = d64s[2 * j], d64s[2 * j + 1]
                if (np.abs(d_odd - eps_l) > RANGE_BAND).any():
                    raise AssertionError("long DTW range: device and host "
                                         "hit sets differ off the boundary")
                if len(d_dev) and np.abs(d_dev - res.dists).max() > 5e-3:
                    raise AssertionError("long DTW range distances off the "
                                         "float64 DP")
        st = [r_.stats for r_ in got]
        lq[measure + "_range"] = {
            "eps": eps_l, "band": band_l, "wall_s": range_wall,
            "launches": rl,
            "hits": r_hits, "boundary_windows": r_edge,
            "overflows": sum(x.stats.range_overflows for x in rgot)}
        log(f"[15] long {measure} range: {len(qs_l)} queries at eps "
            f"{eps_l:.4f} in {range_wall:.2f} s; launches {rl}; {r_hits} "
            f"hits = the "
            + ("float64 brute force's" if measure == "ed"
               else "host backend's")
            + f" ({r_edge} windows within {band_l:.3g} of eps)")
        lq[measure] = {
            "queries": len(qs_l), "qlen": qlen, "wall_s": wall,
            "launches": ll, "max_abs_err_vs_float64": worst,
            "host_wall_s": host_wall, "max_abs_err_vs_host": host_err,
            "mean_chunks_visited": float(np.mean([x.chunks_visited
                                                  for x in st])),
            "mean_true_dists": float(np.mean([x.true_dist_computations
                                              for x in st]))}
        if measure == "dtw":
            # the DP's work on this path: survivors a query and a launch
            lq[measure]["mean_dtw_full"] = float(np.mean([x.dtw_full
                                                          for x in st]))
            lq[measure]["dtw_per_launch"] = (
                sum(x.dtw_full for x in st)
                / max(1, ll["dtw_survivors_wide"]))
            log(f"[15] long DTW path: {lq[measure]['mean_dtw_full']:.1f} "
                f"DPs a query, {lq[measure]['dtw_per_launch']:.1f} a "
                f"dtw_survivors_wide launch; the host query's launches "
                f"{lq['dtw_host_launches']}")
        log(f"[15] long {measure} path: {len(qs_l)} queries of qlen {qlen}"
            + (f" at r {LQ_R}" if measure == "dtw" else "")
            + f" in {wall:.2f} s; launches {ll}; mean chunks "
            f"{lq[measure]['mean_chunks_visited']:.1f}; answers = the "
            + ("float64 brute force" if measure == "ed" else
               f"host backend's ({host_wall:.2f} s, max |d - d_host| "
               f"{host_err:.2e}) and a float64 DP of each reported window")
            + f" (max |d - d64| {worst:.2e})")
    log(f"[15] batch walls (host clock, B = {BATCH}): ED k-NN "
        f"{lq['ed']['wall_s']:.4f} s, ED range {lq['ed_range']['wall_s']:.4f}"
        f" s, DTW k-NN {lq['dtw']['wall_s']:.4f} s, DTW range "
        f"{lq['dtw_range']['wall_s']:.4f} s")
    # the long-row chunk entries, mindist and the unstaged build at this
    # phase's shapes (B = 8; the chunk entries over 128 kept rows, every
    # window in its series)
    index_l = qengine.index
    lenv = index_l.envelopes
    for measure, qlen in (("ed", LQ_ED), ("dtw", LQ_DTW)):
        rows = 128
        n_pad = 4 * rows
        pick = torch.from_numpy(lq_rng.integers(
            0, lenv.size, (BATCH, n_pad))).to(dev)
        sids = lenv.series_id[pick].contiguous()
        fits = LQ_LEN - qlen - (qp.gamma + 1)
        anc = torch.from_numpy(lq_rng.integers(0, fits + 1, (
            BATCH, n_pad)).astype(np.int32)).to(dev)
        a0 = (qcoll.data, qcoll.csum, qcoll.csum2, qcoll.csum_lo,
              qcoll.csum2_lo, qcoll.center)
        qt = torch.from_numpy(np.stack(lq_queries[measure])).to(dev)
        # the distinct region elements and prefix-sum positions of a call
        covered = gather_bytes(torch, qcoll, sids[:, :rows].reshape(-1),
                               anc[:, :rows].reshape(-1), qlen, g)
        if measure == "ed":
            qn = planner.prepare_query_batch(qt, qp.seg_len, True)[0]
            plan = (sids, anc, torch.full_like(sids, g),
                    torch.zeros((BATCH, n_pad), device=dev))
            pool_inf = torch.full((BATCH, K), float("inf"), device=dev)
            st_k = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
            call = [lambda i=i: fused_gather_ed_chunk_long(
                *a0, *plan, qn, pool_inf, st_k, i=i, chunk=rows, g=g,
                znorm=True) for i in range(4)]
            plain = [lambda i=i: ref.fused_gather_ed_chunk_ref(
                *a0, *plan, qn, pool_inf, st_k.clone(), i=i, chunk=rows,
                g=g, znorm=True) for i in range(4)]
            ok_c = BATCH * rows * g
            tile = fused_verify_mod.ed_chunk_tile(
                qlen, g, True, batch=BATCH, rows=rows,
                sms=torch.cuda.get_device_properties(dev)
                .multi_processor_count)
            nbytes = (covered + BATCH * rows * 16 + BATCH * qlen * 4
                      + 4 * BATCH * -(-rows // tile) * min(K, tile * g) * 4)
            timings[("fused_gather_ed_long", qlen, rows)] = timing(
                torch, call, plain, nbytes, 2 * qlen * ok_c, 0.0,
                f"B={BATCH} rows={rows} qlen={qlen} ok/call={ok_c}")
            # the range mode's long-row variant: every row kept, the dense
            # d2 out
            eps2_big = torch.full((BATCH,), 1e30, device=dev)
            no_ovf = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
            got = fused_gather_ed_range_long(
                *a0, *plan, qn, eps2_big, no_ovf, st_k.clone(), i=0,
                chunk=rows, g=g, znorm=True)
            check_equal(torch, "fused_gather_ed_range_long vs contract", got,
                        ref.fused_gather_ed_range_ref(
                            *a0, *plan, qn, eps2_big, no_ovf, st_k.clone(),
                            i=0, chunk=rows, g=g, znorm=True,
                            dist=fused_gather_ed_long(
                                *a0, sids[:, :rows].reshape(-1).contiguous(),
                                anc[:, :rows].reshape(-1).contiguous(), qn,
                                g=g, rows=rows, znorm=True)))
            # (the queries are noisy windows of the 32 series, so the
            # candidates near their sources are near matches: the
            # identity's rounding is relative to 2 qlen, not to their d2)
            range_err = check_close(
                torch, "fused_gather_ed_long", got,
                ref.fused_gather_ed_range_ref(
                    *a0, *plan, qn, eps2_big, no_ovf, st_k.clone(), i=0,
                    chunk=rows, g=g, znorm=True), scale=2.0 * qlen)
            call = [lambda i=i: fused_gather_ed_range_long(
                *a0, *plan, qn, eps2_big, no_ovf, st_k, i=i, chunk=rows,
                g=g, znorm=True) for i in range(4)]
            plain = [lambda i=i: ref.fused_gather_ed_range_ref(
                *a0, *plan, qn, eps2_big, no_ovf, st_k.clone(), i=i,
                chunk=rows, g=g, znorm=True) for i in range(4)]
            timings[("fused_gather_ed_range_long", qlen, rows)] = timing(
                torch, call, plain, covered + BATCH * rows * 16
                + BATCH * qlen * 4 + 2 * BATCH * 4 + ok_c * 4,
                2 * qlen * ok_c, range_err,
                f"B={BATCH} rows={rows} qlen={qlen} ok/call={ok_c}")
        else:
            _, dlo, dhi, _, _ = planner.prepare_query_batch(
                qt, qp.seg_len, True, "dtw", LQ_R)
            # every bound 0 under a cut of 1e-30 (the pool's k-th, or
            # eps2): every query active, every row kept, every candidate
            # ok, so the LB of every candidate is computed and checked;
            # only a window inside the query's envelope (lb2 0) survives
            plan = (sids, anc, torch.full_like(sids, g),
                    torch.zeros((BATCH, n_pad), device=dev))
            m = BATCH * rows * g
            # `covered` counts every candidate's window elements and
            # prefix sums: here every candidate is ok
            nbytes = (covered + BATCH * rows * 16 + 2 * BATCH * qlen * 4
                      + 3 * m * 4 + m * 4 + 2 * m * 4)
            for name, cut, ovf_l, entry, plain_fn in (
                    ("fused_gather_lb_keogh_long",
                     torch.full((BATCH, 1), 1e-30, device=dev), None,
                     fused_gather_lb_keogh_chunk_long,
                     ref.fused_gather_lb_keogh_chunk_ref),
                    ("fused_gather_lb_keogh_range_long",
                     torch.full((BATCH,), 1e-30, device=dev),
                     torch.full((BATCH,), 4, dtype=torch.int32, device=dev),
                     fused_gather_lb_keogh_range_long,
                     ref.fused_gather_lb_keogh_range_ref)):
                tail = (cut,) if ovf_l is None else (cut, ovf_l)
                st_l = torch.zeros((BATCH, 6), dtype=torch.int32, device=dev)
                call = [lambda i=i: entry(*a0, *plan, dlo, dhi, *tail, st_l,
                                          i=i, chunk=rows, g=g, znorm=True)
                        for i in range(4)]
                plain = [lambda i=i: plain_fn(
                    *a0, *plan, dlo, dhi, *tail, st_l.clone(), i=i,
                    chunk=rows, g=g, znorm=True) for i in range(4)]
                got, want = call[0](), plain[0]()
                err = check_close(torch, "fused_gather_lb_keogh_long",
                                  got[0], want[0])
                for x, y in zip(got[1:3], want[1:3]):
                    check_equal(torch, f"{name} mu/sd", x, y)
                # the survivors (lb2 exactly 0 at this cut) and every
                # counter: the plain version's
                st_a, st_b = (torch.zeros((BATCH, 6), dtype=torch.int32,
                                          device=dev) for _ in range(2))
                got_s = entry(*a0, *plan, dlo, dhi, *tail, st_a, i=0,
                              chunk=rows, g=g, znorm=True)
                want_s = plain_fn(*a0, *plan, dlo, dhi, *tail, st_b, i=0,
                                  chunk=rows, g=g, znorm=True)
                check_equal(torch, f"{name} counters", st_a, st_b)
                check_equal(torch, f"{name} nsurv", got_s[4], want_s[4])
                for b_ in range(BATCH):
                    n_b = int(want_s[4][b_])
                    check_equal(torch, f"{name} survivors",
                                got_s[3][b_, :n_b].sort().values,
                                want_s[3][b_, :n_b].sort().values)
                ok_c = int(st_l[:, 3].sum())      # the entry's own count
                if ok_c != m:
                    raise AssertionError(f"{name}: {ok_c} of {m} candidates "
                                         "ok")
                timings[(name, qlen, rows)] = timing(
                    torch, call, plain, nbytes, 10 * ok_c * qlen, err,
                    f"B={BATCH} rows={rows} qlen={qlen} r={LQ_R} "
                    f"ok/call={ok_c} surv/call={int(got[4].sum())}",
                    events=2)
            # the DP over a chunk's survivors at this (qlen, r): M =
            # LQ_DP_M candidates a query, every fourth a survivor (the
            # path above runs ~2,300 a launch; the plain version's 40,000
            # diagonals run once, checked and timed)
            s_args, s_d2 = survivor_inputs(torch, dev, lq_rng, qcoll.data,
                                           qlen, m=LQ_DP_M)
            n_surv = int(s_args[3].sum())
            call = [lambda: dtw_survivors_wide(*s_args, s_d2.clone(),
                                               r=LQ_R, znorm=True)]
            want, p_ms = timed_call(torch, lambda: ref.dtw_survivors_ref(
                *s_args, s_d2.clone(), r=LQ_R, znorm=True))
            err = check_equal(torch, "dtw_survivors_wide at [15]'s shape",
                              call[0](), want)
            timings[("dtw_survivors_wide", qlen)] = timing(
                torch, call, None, n_surv * (qlen * 4 + 6 * 4)
                + BATCH * qlen * 4 + BATCH * 4,
                5 * n_surv * dtw_cells(qlen, LQ_R), err,
                f"B={BATCH} M={LQ_DP_M} r={LQ_R} surv={n_surv}",
                plain_ms=p_ms)
            del s_args, s_d2
        del call, plain
        # mindist over the long index's envelopes and blocks at this nseg
        nseg = qp.query_segments(qlen)
        _, _, _, qb, qh = planner.prepare_query_batch(qt, qp.seg_len, True)
        fine_l = index_l.levels[-1]
        for name, n_rows, call, plain in (
                ("mindist_sym", lenv.size,
                 [lambda: mindist_sym(qb, qh, lenv.sym_lo, lenv.sym_hi,
                                      index_l.breakpoints, lenv.valid,
                                      qp.seg_len, nseg)],
                 [lambda: ref.mindist_sym_ref(qb, qh, lenv.sym_lo,
                                              lenv.sym_hi,
                                              index_l.breakpoints,
                                              lenv.valid, qp.seg_len,
                                              nseg)]),
                ("mindist_paa", fine_l.size,
                 [lambda: mindist_paa(qb, qh, fine_l.paa_lo, fine_l.paa_hi,
                                      fine_l.valid, qp.seg_len, nseg)],
                 [lambda: ref.mindist_ref(qb, qh, fine_l.paa_lo,
                                          fine_l.paa_hi, fine_l.valid,
                                          qp.seg_len, nseg)])):
            got, want = call[0](), plain[0]()
            err = check_close(torch, name, got, want)
            check_equal(torch, f"{name} at qlen {qlen}", got, want)
            del got, want
            errs[name] = max(errs[name], err)
            timings[(name, qlen)] = timing(
                torch, call, plain,
                2 * n_rows * nseg * 4 + n_rows + BATCH * n_rows * 4
                + 2 * BATCH * nseg * 4, 7 * BATCH * n_rows * nseg, err,
                f"B={BATCH} N={n_rows} nseg={nseg}")
    # the build past 16 segments (the slab kernel) over the phase's
    # collection, from the build's own prefix sums; its plain version on
    # the first series (timed) and on the last (a series offset and a
    # block order other than 0's; at 32 it would take minutes), bit for
    # bit; a digest of every envelope (chip_kernels.py --envelope gives the same
    # one on any tree: the parent's envelopes equal these)
    sums = core_envelope.centered_prefixes(qcoll.data)
    ekw_l = dict(lmin=qp.lmin, lmax=qp.lmax, gamma=qp.gamma,
                 seg_len=qp.seg_len)
    lq_plan = envelope_plan(LQ_LEN, qp.lmin, qp.lmax, qp.gamma, qp.seg_len)
    got_l = envelope_znorm(*sums, **ekw_l)
    want_l, p_ms = timed_call(torch, lambda: ref.envelope_znorm_ref(
        sums[0][:1], sums[1][:1], **ekw_l))
    for k_, c_ in zip(got_l, want_l):
        check_equal(torch, "envelope_znorm at [15]'s shape (series 0)",
                    k_[:1], c_)
    want_l = ref.envelope_znorm_ref(sums[0][-1:], sums[1][-1:], **ekw_l)
    for k_, c_ in zip(got_l, want_l):
        check_equal(torch, f"envelope_znorm at [15]'s shape (series "
                    f"{LQ_SERIES - 1})", k_[-1:], c_)
    env_sha = hashlib.sha256(got_l[0].cpu().numpy().tobytes())
    env_sha.update(got_l[1].cpu().numpy().tobytes())
    del got_l, want_l
    cells, len_pairs, seg_pairs = envelope_work(qp, LQ_LEN)
    n_env_l = qp.num_envelopes(LQ_LEN)
    t_l = timings[("envelope_znorm", "long")] = timing(
        torch, [lambda: envelope_znorm(*sums, **ekw_l)], None,
        LQ_SERIES * (2 * (LQ_LEN + 1) * 4 + 2 * n_env_l * qp.w * 4),
        LQ_SERIES * (4 * cells + 9 * len_pairs + 2 * seg_pairs), 0.0,
        f"S={LQ_SERIES} n={LQ_LEN} w={qp.w} plan={lq_plan} (plain: S=1)",
        plain_ms=p_ms)
    lq["envelope_znorm_ms"] = t_l["ms"]
    lq["envelope_znorm_bound_ms"] = t_l["bound_ms"]
    lq["envelope_znorm_cells"] = LQ_SERIES * cells
    lq["envelope_znorm_plan"] = lq_plan
    lq["envelope_sha256"] = env_sha.hexdigest()[:16]
    # the cells' own issue at full rate: 6 slots a cell (znorm_point's
    # subtract, multiply and 2 FMAs, a min and a max), 4 schedulers of 32
    # lanes an SM at the boost clock
    lq["envelope_znorm_issue_floor_ms"] = (
        6 * LQ_SERIES * cells / (sms * 4 * 32 * SPIN_HZ) * 1e3)
    del sums
    for key, t in timings.items():
        if key[0] in ("fused_gather_ed_long", "fused_gather_lb_keogh_long",
                      "fused_gather_ed_range_long",
                      "fused_gather_lb_keogh_range_long") \
                or (key[0].startswith(("mindist", "dtw_")) and key[1] in (
                    LQ_ED, LQ_DTW)):
            log(f"[15] {key[0]:26s} {t['shape']:40s} kernel {t['ms']:.4f} ms"
                f"  plain {t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} "
                f"ms ({t['bound_by']}, {t['timer']}/{t['plain_timer']})")
    log(f"[15] envelope_znorm past 16 segments (plan {lq_plan}): "
        f"{lq['envelope_znorm_ms']:.1f} ms a launch over {LQ_SERIES} x "
        f"{LQ_LEN} ({lq['envelope_znorm_cells']} cells; bound "
        f"{lq['envelope_znorm_bound_ms']:.1f} ms, operations; issue floor "
        f"{lq['envelope_znorm_issue_floor_ms']:.1f} ms; {t_l['timer']}); "
        f"plain {p_ms:.1f} ms on 1 series; envelopes sha256 "
        f"{lq['envelope_sha256']}; the index built in {lq_build_s:.3f} s")
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    del qengine, qcoll

    phase_done("15")

    # -- 16. eps-range at full size ------------------------------------------
    range_cases = ([("ed", qlen, 0, batches[i]) for i, qlen in
                    enumerate(QLENS)]
                   + [("dtw", qlen, r, qs) for (qlen, r), qs in
                      zip(DTW_CASES, dtw_batches)])
    (results["range_path"], range_launches, results["traced_range_scan"],
     range_answers) = range_phase(
        torch, engine, p, range_cases, dtw_oracle, timings, zero_counts,
        read_counts)
    results["range_launches"] = range_launches
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}

    phase_done("16")

    # -- 17. storage and ingestion -----------------------------------------
    range_eps = next(c["eps"] for c in results["range_path"]
                     if c["measure"] == "ed" and c["qlen"] == QLENS[0])
    t0 = time.perf_counter()
    results["storage"], appended = storage_phase(
        torch, engine, data, p, batches, answers, dtw_batches, dtw_specs,
        dtw_answers, range_eps, zero_counts, read_counts, args.seed)
    results["storage"]["phase_s"] = time.perf_counter() - t0
    log(f"[17] storage and ingestion phase: "
        f"{results['storage']['phase_s']:.1f} s")

    phase_done("17")

    # -- 19. the sharded search (before [18]: its writer lane grows the
    # engine whose answers [19] is held to) ---------------------------------
    t0 = time.perf_counter()
    results["sharded"] = sharded_phase(
        torch, engine, data, p, batches, answers, dtw_batches, dtw_specs,
        dtw_answers, range_cases, results["range_path"], range_answers,
        timings, appended, range_eps, card, args.seed)
    results["sharded"]["phase_s"] = time.perf_counter() - t0
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    log(f"[19] sharded search phase: {results['sharded']['phase_s']:.1f} s")
    phase_done("19+20")

    # -- 21. P5 on the card: g past one block, the offset-tiled entries --
    results["large_g"], large_g_launches = large_g_phase(
        torch, dev, args.seed, timings, zero_counts, read_counts)
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    phase_done("21")

    # -- 22. rank grids and the training collectives ----------------------
    results["grid"] = grid_phase(torch, engine, data, p, batches,
                                 dtw_batches, dtw_specs, args.seed)
    phase_done("22")

    # -- 23. the host-sync budget and the examples --------------------------
    results["r2"] = audit_examples_phase(torch, engine, data, p, args.seed)
    phase_done("23")

    # -- 18. serving on the card (last: its writer lane grows the engine) --
    t0 = time.perf_counter()
    results["serve"] = serve_phase(torch, engine, data, p, zero_counts,
                                   read_counts, args.seed)
    results["serve"]["phase_s"] = time.perf_counter() - t0
    log(f"[18] serving phase: {results['serve']['phase_s']:.1f} s")
    phase_done("18")
    log("phase seconds: " + json.dumps({k: round(v, 1)
                                        for k, v in phase_s.items()})
        + f"; total {sum(phase_s.values()):.1f}")

    # launches: each kernel's count on the path it belongs to — the ED main
    # path, the DTW path, the index build, the host backend (ED: batch_ed;
    # DTW: lb_keogh and dtw_band), the long DTW path (the wide entries)
    headline = {
                # the scan's entry to the kernel (the contract entry's
                # time is in the timings as well)
                "fused_gather_ed": ("fused_gather_ed_chunk", 256, 512),
                "mindist_sym": ("mindist_sym", 256),
                "mindist_paa": ("mindist_paa", 256),
                # the scan's entry to the kernel (the contract entry's
                # time is in the timings as well)
                "fused_gather_lb_keogh": ("fused_gather_lb_keogh_chunk", 256,
                                          512),
                "dtw_survivors": ("dtw_survivors", 256),
                "dtw_band": ("dtw_band", 256),
                "dtw_survivors_wide": ("dtw_survivors_wide", LONG_CASE[0]),
                "dtw_band_wide": ("dtw_band_wide", LONG_CASE[0]),
                # the wide entries at the long-query phase's (qlen, r)
                "dtw_survivors_wide_long": ("dtw_survivors_wide", LQ_DTW),
                "dtw_band_wide_long": ("dtw_band_wide", LQ_DTW),
                "envelope_znorm": ("envelope_znorm",),
                # the build past 16 segments: [15]'s index (its plain
                # version timed on the first series, as its shape says)
                "envelope_znorm_long": ("envelope_znorm", "long"),
                "batch_ed": ("batch_ed", 256, 1, "znorm"),
                "lb_keogh": ("lb_keogh", 256),
                "pool_merge": ("pool_merge", 256),
                "pool_merge_dense": ("pool_merge_dense", 256),
                # the long-row chunk entries at the long phase's shapes
                "fused_gather_ed_long": ("fused_gather_ed_long", LQ_ED, 128),
                "fused_gather_lb_keogh_long": ("fused_gather_lb_keogh_long",
                                               LQ_DTW, 128),
                # the range modes at [16]'s packs (qlen 256) and at the long
                # phase's shapes, and the hit append of [16]'s ED steps
                "fused_gather_ed_range": ("fused_gather_ed_range", 256, 512),
                "fused_gather_lb_keogh_range": ("fused_gather_lb_keogh_range",
                                                256, 512),
                "fused_gather_ed_range_long": ("fused_gather_ed_range_long",
                                               LQ_ED, 128),
                "fused_gather_lb_keogh_range_long": (
                    "fused_gather_lb_keogh_range_long", LQ_DTW, 128),
                "range_append": ("range_append", "ed", 256),
                # [20]: the k-NN chunk entries as the sharded scan's delta
                # family runs them (gkth, a delta-first plan, the ids then
                # mapped through the rank's gmap)
                "fused_gather_ed_chunk_gkth_gmap": (
                    "fused_gather_ed_chunk", 256, GKTH_ROWS, "gkth+gmap"),
                "fused_gather_lb_keogh_chunk_gkth_gmap": (
                    "fused_gather_lb_keogh_chunk", 256, GKTH_ROWS,
                    "gkth+gmap"),
                # [21]: the long-row k-NN chunk entries past one block's
                # g, a row's offsets tiled across blocks (g = 20,480)
                "fused_gather_ed_tiled": (
                    "fused_gather_ed_chunk_long_tiled", 256, LARGE_G_ROWS),
                "fused_gather_lb_keogh_tiled": (
                    "fused_gather_lb_keogh_chunk_long_tiled", 256,
                    LARGE_G_ROWS)}
    ingest = results["sharded"]["ingest"]
    path_launches = dict(
        launches, fused_gather_ed=launches["fused_gather_ed_chunk"],
        pool_merge=launches["pool_merge_partials"],
        pool_merge_dense=dtw_launches["pool_merge"],
        fused_gather_lb_keogh=dtw_launches[
            "fused_gather_lb_keogh_chunk"],
        dtw_survivors=dtw_launches["dtw_survivors"],
        **build_launches,
        batch_ed=results["host_path"]["ed"]["launches"]["batch_ed"],
        **{name: results["host_path"]["dtw"]["launches"][name]
           for name in ("lb_keogh", "dtw_band")},
        dtw_survivors_wide=results["long_path"]["device"]["launches"][
            "dtw_survivors_wide"],
        dtw_band_wide=results["long_path"]["host"]["launches"][
            "dtw_band_wide"],
        dtw_survivors_wide_long=lq["dtw"]["launches"]["dtw_survivors_wide"],
        dtw_band_wide_long=lq["dtw_host_launches"]["dtw_band_wide"],
        envelope_znorm_long=lq_build["envelope_znorm"],
        fused_gather_ed_long=lq["ed"]["launches"][
            "fused_gather_ed_chunk_long"],
        fused_gather_lb_keogh_long=lq["dtw"]["launches"][
            "fused_gather_lb_keogh_chunk_long"],
        fused_gather_ed_range=range_launches["fused_gather_ed_range"],
        fused_gather_lb_keogh_range=range_launches[
            "fused_gather_lb_keogh_range"],
        range_append=range_launches["range_append"],
        fused_gather_ed_range_long=lq["ed_range"]["launches"][
            "fused_gather_ed_range_long"],
        fused_gather_lb_keogh_range_long=lq["dtw_range"]["launches"][
            "fused_gather_lb_keogh_range_long"],
        **{f"{name}_gkth_gmap": sum(w["launches"][name]
                                    for w in ingest.values())
           for name in ("fused_gather_ed_chunk",
                        "fused_gather_lb_keogh_chunk")},
        fused_gather_ed_tiled=large_g_launches["fused_gather_ed_chunk_long"],
        fused_gather_lb_keogh_tiled=large_g_launches[
            "fused_gather_lb_keogh_chunk_long"])
    for name, key in headline.items():
        t = timings[key]
        src, replaces = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": max(errs.get(name, 0.0), t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    results["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
