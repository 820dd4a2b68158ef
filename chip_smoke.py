#!/usr/bin/env python3
"""Quickest proof that fqsqueezer_tpu_torch runs on a CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports fqsqueezer_tpu_torch and nothing of the reference package or of
JAX, and fails if its run pulled either in.
Phases, one line each; any failure raises and the script exits non-zero:
  1. device  — needs CUDA; prints the card's name and power limit.
  2. build   — compiles the kernels from csrc/ (nvcc, sm_90a) and prints
               their registers and shared memory.
  3. k1      — kernel K1 against its plain torch version on the card, exact:
               the tests' shapes, the main path's shape, an adversarial grid
               (edge freqs and edge starting states), a group-sized grid,
               and the flush's three-stream launch against the plain walk
               of each stream and against three single walks. Then
               times at the main path's shape: the walk alone, the plain
               walk, the whole group encode (walk + compaction), and one
               three-stream launch against three single launches.
  4. digest  — compresses 20,000 bench reads through the port's CLI with
               the bench primary row's flags (BENCH_ROW) and no --device, so
               on the card; the archive's sha256 must equal the reference
               package's (DIGEST_20K) and K1 must have run.
  5. full    — the 100,000-read bench corpus through
               pipeline.compress_file, warm-up + timed run; prints reads/s,
               bits/base, wall time and peak CUDA memory, holds the archive
               to DIGEST_100K and K1 to at least one launch a group flush.
  6. modes   — every other SE original-order mode: the 20k corpus through
               the CLI's e and d with -qm 4 -im i and -qm 2 -qt 20 -im n,
               the 100k corpus through pipeline.compress_file and
               decompress_file (warm-up + timed run) with -qm o -im o (2048
               lanes) and -qm n -im o (1024 lanes); each archive's sha256
               must equal the reference writer's, each decode the input's
               bytes (lossless) or the reference decoder's sha256; K3 must
               launch once a batch where there is a quality stream and
               never without one, K2 once a read row. Prints reads/s both
               ways.
  7. sorted  — sorted read order (-om s), the CLI's default path: (a) the
               20k corpus through the CLI's e with only -gs 5 (so -s -om s
               -qm 8 -im i, 1024 lanes) and d, the archive's and the
               decode's sha256 held to the reference package's
               (SORTED_CLI); (b) the 100k corpus at the bench's sorted row
               (-om s -qm 8 -im n -gs 5) through pipeline.compress_file and
               decompress_file, warm-up + timed run, both digests held
               (SORTED_100K) and bits/base 2.5914; (c) the 20k corpus
               block-streamed (STREAM_CHUNK) at -om s -im n (the external
               bin sort) and at -om o -im o (the header prescan), each
               archive's sha256 held to the in-RAM archive's. K2 must
               launch once a read row (4 a batch at 1024 lanes), K3 once a
               batch, K1 at least once a group flush. Prints reads/s both
               ways and peak CUDA memory.
  8. pe      — paired-end reads (-p), with the anchored 3-row recoding:
               (a) 10,000 pairs of write_pe_corpus(.., seed=42) through
               the CLI's e with only -p -gs 5 (so PE sorted order, -qm 8
               -im i, 1024 lanes) and d -out -out2, the archive's and both
               decodes' sha256 held to the reference package's (PE_CLI);
               (b) the bench's PE row (50,000 pairs, -p -om o -qm n -im n
               -gs 5) through pipeline.compress_pe and decompress_file,
               warm-up + timed run, the three digests held (PE_100K) and
               the bits/base (PE_BITS_PER_BASE); prints reads/s both ways
               (both mates counted), peak CUDA memory and the bytes
               against the C++ reference's archive (bench.py's
               REF_PE_BYTES); (c) the 10,000 pairs block-streamed
               (STREAM_CHUNK) at -p -om o -im o, held to the in-RAM
               archive. K2 must launch once an expanded row (read1, rowA,
               rowB: 6 a full batch), K1 at least once a group flush, K3
               once a batch where there is a quality stream.
  9. verify  — the repository's Tier-1 verify corpus (3,000 x 80 bp, seed
               9) through the CLI with -qm o -im o -gs 1: the archive's
               sha256 must be the reference writer's, and its decode the
               input's bytes (BYTE-EXACT).
 10. resume  — group snapshots and resume (RESUME_SE: the 20k corpus at
               -s -om o -qm 8 -im i -gs 5, 2048 lanes; RESUME_PE: 10,000
               pairs at -p -om o -qm 8 -im i -gs 5, 1024 lanes; a group
               budget that gives several groups): compress without and with
               snapshot_prefix (the archives equal, and the reference
               writer's sha256 and group count), the group-1 snapshot's
               arrays held to the reference's by sha256, then one
               load_state and two decodes from group 1 (start_group,
               init_state), each the tail of the full decode, and the
               loaded state's arrays unchanged after them. Prints the
               snapshot's size, the compress time with and without
               snapshots, save_state's time and the tails' decode times.
 11. mesh    — the committed -gs 5 mesh fixtures (MESH_FIXTURES: an SE
               archive of the reference's 4x2 mesh writer at -qm 8 -im o, a
               PE one of its 2x1 writer at -qm n -im n with the anchors;
               16 lanes, so that each shard decodes two read rows or more a
               batch) through the CLI's d, which routes a mesh header to
               the sequential mesh decode: each output's sha256 held to the
               reference's sequential decoder's, K2 launched once a read
               row of each dp shard (dp x the rows a shard walks, expanded
               rows with the anchors) and K3 once a shard and batch with a
               quality stream. Prints the decode's wall time (one call,
               its first call's costs included: the fixtures are small)
               and the copy of the K2 tables each shard decodes against,
               timed alone.
 12. mesh_write — mesh archives written on the card: (a) the two
               committed -gs 5 mesh fixtures (MESH_WRITE_FIXTURES, their
               inputs and Params as the reference's writer had them)
               through mesh_pipeline.compress_file_mesh, each archive's
               sha256 held to the committed file's, K1 launched once a
               group (every stream's [T, dp x N] grid in one launch); (b)
               the CLI's e -dp/-tp at full width (MESH_WRITE_CLI: the 100k
               corpus at -s -om o -qm o -im o -gs 5 -dp 4 -tp 2, 2048
               lanes a shard, 8192-read batches; 10,000 pairs at -p -om o
               -qm o -im o -gs 5 -dp 2 -tp 1, 1024 lanes a shard) and its
               d: the decode equal to the input (BYTE-EXACT, both mates),
               K1 once a group, K2 once a read row of each shard (expanded
               rows with the PE anchors), K3 once a shard and batch.
               Prints each compress's and decode's time and reads/s. (c)
               The single-step encoders (pipeline._encode_batch, and
               sharded.sharded_encode at 4 x 2) on a tiny batch on the
               card: exactly their CPU outputs, one K1 launch each.
 13. mesh_legacy — mesh archives of every header a JAX mesh writer
               stores: (a) the committed fixtures of testdata/mesh_legacy
               (MESH_LEGACY_FIXTURES: H0 on 2x2 and 2x1 meshes, SE, PE with
               the anchors off and sorted order; H1 SE and PE with its
               local tables and deltas per shard; H4 on 4x2; H6 on 2x2;
               today's header at mesh_route_sb 1 on 2x4, once with nothing
               dropped and once with the route cap's drop) written on the
               card from their regenerated inputs, each sha256 the
               committed file's, K1 once a group, and decoded through the
               CLI's d to the reference's digests (SHA256SUMS), K2 once a
               read row of each shard and K3 once a shard and batch —
               route_drop_dp2tp4's decode failing with the reference's
               payload checksum error (ROADMAP.md F7); (b) the 100k corpus
               at -s -om o -qm o -im o -gs 5 under H0 and H4 at -dp 4 -tp 2
               and under today's header at mesh_route_sb 1, -dp 2 -tp 4
               (MESH_LEGACY_FULL): compress and decode timed, BYTE-EXACT,
               peak CUDA memory, the dropped events, each K2 and K3
               launch's device time; (c) the per-shard copy of the K2
               tables: timed where the family has a row update (H6,
               today's), none for the batch-frozen ones (H0, H4).
 14. mesh_ranks — the dp x tp mesh on several processes, one rank each
               (parallel.mesh_pipeline.run_ranks): (a) NCCL at world 1:
               every testdata/mesh and testdata/mesh_legacy fixture written
               on the rank (== the committed archive; snap_dp2tp1's
               group-1 snapshot == the committed one) and the committed
               archives decoded (== the JAX decoders' SHA256SUMS and
               MESH_FIXTURES; route_drop_dp2tp4, whose route cap dropped
               events, == the JAX mesh decode's MESH_RANKS_DROP: the ranks
               replay the writer's routed exchange), snap_dp2tp1 also from
               its committed snapshot; a gather of known tensors == their
               concatenation in rank order; K1 once a group flush on every
               rank, K2 once a shard row and K3 once a shard and batch
               over the ranks; (b) gloo ranks sharing the one card, R = dp
               (2 and 4): the same for the fixtures of that dp, and on 2
               ranks the 100k corpus at MESH_RANKS_SHARED compressed (==
               the one-process writer's archive in this run) and decoded
               (BYTE-EXACT), walls printed as no speed figure; (c) where
               torch sees 2 cards or more, NCCL across min(cards, 4) cards
               at MESH_RANKS_CARDS on the 100k corpus, compress and decode
               timed (warm-up, then timed) beside one process on one
               card, with the card's name and power limit; on one card a
               line says only (a) and (b) ran.
 15. legacy  — the JAX package's older writers (params.HEADER_GENERATIONS:
               H0, the first writer's batch-frozen table_* tables, ctx v1,
               no mix or ramp, three repairs, id codec v1; H1-H4, the same
               with in-batch local statistics: local_* tables of 2^22
               cells, under H1 DNA and quality model deltas, H2 without
               them and with the mix and ramp, H3 with 2-pass inserts, H4
               over canonical ktable_* tables with klocal_* ones; H5 and
               H6, the row-global ktable_* tables with u16 counters, H6
               with ctx v2 and the rough rescue): LEGACY's archives — the
               20k corpus at -s -om o -qm o -im o -gs 5 under H0-H6 but
               H5's, at -s -om s -qm o -im n under H0 and -s -om s -qm 8
               -im n under H1, and 10k pairs at -p -om o -qm o -im o under
               H6 and H4 — written through pipeline.compress_file /
               compress_pe on the card, each sha256 held to the JAX
               writer's, and decoded through the CLI's d to the input
               (BYTE-EXACT) or the JAX decoder's sha256; then
               LEGACY_FULL's, the 100k corpus under H0, H6, H1 and H4 at
               -s -om o -qm o -im o -gs 5 (2048 lanes), timed both ways,
               BYTE-EXACT, with the local state's peak memory and zeroing
               time. K1 at least once a group flush, K2 once a read row,
               K3 once a batch.
 16. k3      — kernel K3 (the quality decode scan) against its plain torch
               version on the card, exact (symbols, final states, words
               consumed), for every symbol count it takes (2, 4, 8, 96):
               random batches whose lengths include 0, 1 and L (N in {8,
               1024, 2048} and sorted order's 1024 lanes x 4 rows; for 8
               symbols also N in {8, 256, 2048} x L in {40, 104} x r_pl in
               {1, 2}), and the second batch (4096
               reads, 2 read rows, 104 columns) of a real archive of each
               mode, with the quality model the first batch left, and for
               8 symbols that of the sorted archive (1024 lanes, 4 read
               rows, timed beside its chain floor). Then on
               that batch K3 and the plain scan timed, the chain floor (K3
               on 32 lanes) and the bound. K3 with in-batch deltas
               likewise at 8 and 96 symbols: random batches, then the
               real batch of [legacy]'s H1 archive of the count (-qm o
               original order, -qm 8 sorted order); at 2 and 4 symbols
               random batches only.
 17. k2      — kernel K2 (one read row of the DNA decode — the scan and
               the row's s/b table update — one launch) against its plain
               torch version (the row scan, then _apply_sb_updates) on the
               card, exact (the four planes, final states, words consumed,
               carried registers, both updated tables), row by row:
               encoded random batches (K2_SHAPES: N in {8, 256, 2048},
               lengths 0, 1 and L among them, grown tables, short word
               streams), an adversarial batch (K2_ADVERSARIAL: most
               buckets full, counts at 255, keys in two cells, new keys
               racing for one empty cell), sorted batches whose rows copy
               shared prefixes (K2_LCP_SHAPES: lcp from 0 to the whole
               read, a duplicate lane, the cap of 255 on reads of 264), the
               main path's second batch of the 20k archive with the DNA
               state the first batch left, and the same batch of the 20k
               sorted archive (1024 lanes, 4 rows, prefixes copied);
               paired-end batches whose rowA and rowB copy their anchors
               (K2_PE_SHAPES: N 8 and 1024, rows with and without an
               anchor, anchors at read2's start (a = 0) and end (a = L2 -
               B), empty rowBs, read2 shorter than B), the second batch of
               the bench PE row's archive (1024 lanes, 6 expanded rows)
               and of the PE CLI archive (sorted: read1 rows copy the
               previous read1's prefix). Then
               on each real batch but the PE CLI one K2's launches timed
               (the tables restored
               to the row-start ones before each repetition, outside the
               timed region), the plain row step, the chain floor (K2 on
               32 lanes) and the bound; on the PE batch also the row-end
               PE step (torch ops between K2's launches).
 18. k2_legacy — K2's instantiations for the older headers
               (K2_LEGACY: table cells batch-frozen, alone and with the
               local_* tables and with the DNA deltas too; ktable cells
               with the row update under H5 and H6 and batch-frozen, with
               the klocal_* tables and with the deltas too; K2 cells
               batch-frozen, with the klocal_* tables, and with the row
               update under the older writers' knobs) against the plain
               row step, exact, tables included: encoded random batches
               (K2_LEGACY_SHAPES: N 8, 256 and 2048, grown tables, short
               word streams) and a sorted one each, then the real second
               batches of LEGACY's archives; K2, its chain floor, the
               plain row step and the bound timed on the batches of
               LEGACY_TIMED.
 19. knobs   — the header knobs no CLI flag sets: dna_sorted_ctx (the
               sorted-mode position buckets), dna_pe_pos_ctx (read2's
               coordinates on rowA and rowB) and dna_canon 0 with
               dna_row_global 1 (row-global context-keyed table_* cells):
               (a) KNOB_FIXTURES, the committed JAX-written archives of
               testdata/knobs, written on the card from their regenerated
               inputs (sha256 == the committed file's) and decoded
               through the CLI's d to the JAX decoder's digests
               (SHA256SUMS), K2 once a read row (of each shard for the -dp
               2 -tp 2 mesh); (b) KNOBS_FULL at -gs 5: 20k and 100k reads
               of sorted_ctx (-s -om s -qm 8 -im n) and canon0_rg (-s -om
               o -qm 8 -im n), 10k and 50k pairs of pe_pos (-p -om o -qm n
               -im n), 10k pairs of pe_pos_sorted (-p -om s -qm n -im n),
               each archive and decode held to the JAX package's digests,
               compress and decode timed with peak CUDA memory, K2 once a
               read row with the position maps its rows take
               (dna.K2_POS_LAUNCHES); (c) K2's position-map
               instantiations and the table cells' row-global rows (K2,
               then the row's table update as torch ops) against the plain
               row step, tables included: random sorted and PE batches
               (K2_POS_SORTED_SHAPES, K2_POS_PE_SHAPES), then the real
               second batch of the 100k sorted_ctx, 50k-pair pe_pos and
               100k canon0_rg archives, each K2 timed with chain floor,
               plain time (once) and bound, canon0_rg's without the
               table update, which is timed apart.
 20. decode  — the 20k archive through the port's CLI `d` with no
               --device, and the 100k archive through
               pipeline.decompress_file (warm-up + timed run); the decoded
               FASTQs' sha256 must equal the reference decoder's
               (DIGEST_D20K, DIGEST_D100K), K3 must have launched at
               least once a batch and K2 once a read row. Prints decode
               reads/s, wall time, peak CUDA memory and the launches.
Then the run's wall time; the last two lines are the kernels' JSON record
(K1, K2 at the main path's, sorted order's and the PE row's shape, K2's
table-cell instantiations at H0's original- and sorted-order batches, its
ktable-cell one at H6's, its local-statistics ones at H1's (original and
sorted order), H2's and H4's, its position maps at [knobs]' sorted_ctx
and pe_pos batches and its row-global table cells at canon0_rg's, and K3
for each symbol count and with deltas) and the result line. K1's launches are those of
the three timed compresses (the main path's, the sorted row's and the PE
row's) and of [mesh_write]'s, [mesh_legacy]'s and [mesh_ranks]' mesh
compresses, K3's for 8 symbols those of the two timed SE decodes; the
ranks' K2 and K3 launches of [mesh_ranks] count under the instantiation
each fixture's header and mode run.

The archive digests are sha256 sums of fqsqueezer_tpu.pipeline.
compress_file's archive of write_fastq_corpus(path, n, 100, 4_600_000,
seed=42) at bench_params() (DIGEST_20K, DIGEST_100K), or at the Params the
reference CLI's parse_args makes of a mode row's flags (MODES_20K,
MODES_100K, VERIFY, SORTED_CLI, SORTED_100K), and of fqsqueezer_tpu.
pipeline.compress_pe's archive of write_pe_corpus(path1, path2, n, 100,
4_600_000, seed=42) at the Params of the PE flags (PE_CLI, PE_100K); the
decode digests are sha256 sums of fqsqueezer_tpu.pipeline.
decompress_file's FASTQ output (both mates' files for PE) for those
archives. RESUME_SE and RESUME_PE come from fqsqueezer_tpu.pipeline.
compress_file / compress_pe with snapshot_prefix at the row's budget
(tests/test_torch_checkpoint.py::test_chip_smoke_resume_digests), the
MESH_FIXTURES digests from fqsqueezer_tpu.parallel.mesh_pipeline.
decompress_file_mesh_seq (tests/test_torch_mesh.py::
test_reference_regenerates_fixture_and_digests), the LEGACY and
LEGACY_FULL digests from fqsqueezer_tpu.pipeline.compress_file /
compress_pe at the Params of the reference CLI's parse_args under the
row's header generation, and decompress_file for the decode digest
(tests/test_torch_legacy.py::test_chip_smoke_legacy_digests), the
KNOBS_FULL digests from fqsqueezer_tpu.pipeline.compress_file /
compress_pe at the Params of the reference CLI's parse_args with the
row's knobs set, and decompress_file for each output
(tests/test_torch_knobs.py::test_chip_smoke_knob_digests).
All were computed with the reference package on a CPU.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
SB = 14
DIGEST_READS = 20_000
FULL_READS = 100_000
DIGEST_20K = "0e4aff75f6a6b6c5d1035bd0693fc91718168abab10e2e6ecc2e9e73e701c918"
DIGEST_100K = "d64f884abc5bed9f7ab66b9c535ccc7fd0ef8b9e0ebbd8704d05d3b6fafa4cd6"
DIGEST_D20K = "ea7c1942f71dfd492a10d527c271e8a2ea52519e07f3de75ecfd4a52d3c12fcb"
DIGEST_D100K = "a00dacd9b85ce07c6092b65118fbb9a490edd14d31739630fb5f9d17a1ab999a"
# (T, N) of the K1 checks: the tests' grids, the bench group's dna/qual
# stream (25 batches x 2 read rows x 104 columns, padded to 512 rows), and a
# group of the most batches a flush can hold (64 x 208 rows)
K1_SHAPES = ((40, 256), (256, 256), (300, 256), (5120, 2048), (97, 8),
             (13312, 2048))
K1_ADVERSARIAL = (300, 256)
K1_TIMED = (5120, 2048)
# the bench group's three streams: meta, dna, quality
K1_FLUSH = ((512, 2048), (5120, 2048), (5120, 2048))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT_OPS_PER_S = 67e12      # published non-tensor 32-bit rate, for the ops bound
K1_OPS_PER_SLOT = 12       # compare, shift, select, mulhi, 3 mul-adds, ...
BENCH_ROW = ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5")
# (N, r_pl, L) of the K3 checks on random batches: every symbol count, and
# more shapes for the main path's 8
K3_MODE_SHAPES = ((8, 1, 40), (1024, 2, 104), (2048, 2, 104),
                  (1024, 4, 104))
K3_SHAPES = tuple((n, r, l) for n in (8, 256, 2048) for l in (40, 104)
                  for r in (1, 2))
# K3's operations an active position, counted from the function and not
# from how the kernel computes it: besides the row's cells summed once
# (n_sym adds; the prefix sums fall out of the sum) and a binary search for
# the symbol (log2(n_sym) + 1 steps of a multiply and a compare), the
# symbol's two boundary divides, the state update and renormalisation, and
# the next context
K3_OPS_PER_POS = 16
# K3's symbol counts: (quality mode, the archive of phase_digest or
# phase_modes whose second batch is the mode's real batch)
K3_MODES = ((8, "illumina_8", "bench_20000.fqst"),
            (4, "illumina_4", "qm4_imi_20000.fqst"),
            (2, "binary", "qm2_imn_20000.fqst"),
            (96, "lossless", "qmo_imo_100000.fqst"))
# (tag, flags, archive sha256, decoded FASTQ sha256 or None: the input's
# bytes, for lossless qualities and ids)
MODES_20K = (
    ("qm4_imi", ("-s", "-om", "o", "-qm", "4", "-im", "i", "-gs", "5"),
     "1f12499d209e1a440ea96a602e4ac5e984f3f5379a93ac31597cb4003f0d8f9f",
     "80e0c55d495f2dbc96f509db858423a3eae67c1292cb8b07c8506494d176c8fd"),
    ("qm2_imn", ("-s", "-om", "o", "-qm", "2", "-qt", "20", "-im", "n",
                 "-gs", "5"),
     "4e2164d189ecac81783e0f5878bb67388d1c57fd0e1b1338919645f3263715bf",
     "89d7e488fce6512df461cd6b37c413283bb27923491deb6ba829c7f079819de6"),
)
MODES_100K = (
    ("qmo_imo", ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5"),
     "a97530fe3ecc2e8ba702cd121509e044c3b6a8dc530a08d4a3e4c0bbfc0c46b8",
     None),
    ("qmn_imo", ("-s", "-om", "o", "-qm", "n", "-im", "o", "-gs", "5"),
     "f8601adcce2843c2a706198668447880a2a9f7e89aecf7f46a677df5da0d0042",
     "797290b02e07d317bd69f0806ad292a34c5ad1bc92b1b748ac799f89615b974a"),
)
# sorted order: (flags, archive sha256, decoded FASTQ sha256) of the CLI's
# defaults at -gs 5 on the 20k corpus, and of the bench's sorted row on the
# 100k corpus, whose archive is 2.5914 bits a base (bench.py's sorted row)
SORTED_CLI = (("-gs", "5"),
              "7e028edf547c61c04be04f46a88f0acce87dee74112ffd20b0ae477aa78ac50e",
              "632807c18ecedc88e9db6a40dfd742860d65023b5f83c21368ca9ac911c15c17")
SORTED_100K = (("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs", "5"),
               "516442007a861aa9f086c664d5ffa1c4c45eee051c9bf714105e73e777879921",
               "9d9d844128eccc4f0af2c23bf0601d16f67007b52775c9ce40c2f98dfb8029b4")
SORTED_BITS_PER_BASE = 2.5914
# the streamed compress's chunk: the 20k corpus (about 4.6 MB) in 5 chunks
STREAM_CHUNK = 1 << 20
STREAMED_20K = (("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs", "5"),
                ("-s", "-om", "o", "-qm", "8", "-im", "o", "-gs", "5"))
# paired-end: (pairs, flags, archive sha256, mate 1's and mate 2's decoded
# FASTQ sha256) of the CLI's defaults with -p at -gs 5 (sorted order, -qm 8
# -im i) and of the bench's PE row, whose archive is PE_BITS_PER_BASE bits
# a base
PE_CLI = (10_000, ("-p", "-gs", "5"),
          "a17fd6478c84d59e08c90e1c3cfb49fd74d2fd689bbf0cfd30062822fd0be6c6",
          "8b9c619d63655155f065a64980657699cefeb37d20e02c8472e2644759040299",
          "8ed0bb93f3841fca787ea8fc3e9738d87d87299e820bb5b31798d725bbc14901")
PE_100K = (50_000, ("-p", "-om", "o", "-qm", "n", "-im", "n", "-gs", "5"),
           "2dd15475179828c7165cee1716f030b4e0921b028b4539f16472a7cdbdb326c7",
           "74360fee0d28078bc3d72c31b242610f2a095b8909f1d07e458345c29b809c27",
           "3d3abe48c3eb34cf506c680fd70804ea28559f210091f362f0e57bdf8a5b54f8")
PE_BITS_PER_BASE = 1.1426
PE_STREAMED = ("-p", "-om", "o", "-im", "o", "-gs", "5")
REF_PE_BYTES = 1_386_065   # bench.py: the C++ reference's PE row archive
# the repository's Tier-1 verify recipe: write_fastq_corpus(path, 3000, 80,
# 100_000, seed=9), e -s -om o -qm o -im o -gs 1
VERIFY = (("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "1"),
          "d6b6894ec34ad38bb238629a2d83b06a3598c9bf1b5cdf622fb053fe02f228e0")
# checkpoint and resume: (reads, flags, group budget in bytes, the
# reference writer's archive sha256 at that budget, its group count, and
# the sha256 of each array of its group-1 snapshot in the reference's
# dtype) of the 20k bench corpus and of 10k bench pairs
RESUME_SE = (
    20_000, ("-s", "-om", "o", "-qm", "8", "-im", "i", "-gs", "5"),
    4 << 20,
    "3427cec6504018f3e08df2e6df51b354cb1cbed706ee2af7b2ef923b8c9a2715",
    3, {
        "dna_b_tc":
        "7ee1f015f3ab0ea237c6ef3724ef5f9b6afeff2d94348aac397d7533fa302601",
        "dna_model":
        "f36245e1b3fb61568f44acd7fb3131362314f118456f36c8227954290916f1a6",
        "dna_s_tc":
        "102154153121356933cd0410ce0f9c9b5607e363d96edfc1458e15669f1d4311",
        "dna_siv":
        "b7389c492019a10fc24731fb6dd0ae023b8d35614744c3b84e15f7dc40f486e9",
        "id":
        "168ea5ef5edda61438a20c77c33f24e2d25536568e6d6e468ef94115d66ae72d",
        "meta":
        "605c9a8be2da54e0e88ce9c8980d5305cf80487aea513ae25e39b41136521bdd",
        "qual":
        "8e2ded3cf13f7f908940a24cd9d2d4939b1a2fb3c757d14292ff9a4f7b84c5c4"})
RESUME_PE = (
    10_000, ("-p", "-om", "o", "-qm", "8", "-im", "i", "-gs", "5"),
    4 << 20,
    "708b3d6692773b4b0f7a8c83cd341fc53217753813cd00477e738d8365733240",
    5, {
        "dna_b_tc":
        "e635c6ae3935257ebb87051bd03ffba2884b870cabff702af80a16b8e72e7a19",
        "dna_model":
        "491ae5c0337df28cfd9c41f0fcefb9fa36a918068fb89b7eb31f53f3d8e96bf4",
        "dna_pe_0":
        "bbc546370ef44aa0af4b73af1aff1da7712fc31fbcf1f7ae90dcebd9c6aa8ffd",
        "dna_pe_1":
        "753c0e492951c5c973e55f55d82df6065ed02913948fbd42ed922304a35222df",
        "dna_pe_2":
        "b47ee45f00b042ea98bfaddd3ea446d9b63331e4c2332c941e25e9f23293efde",
        "dna_pe_3":
        "a17a34e5c817aa79d0727a59012b0a8da91f597678ca3ae53e14cac8d1e40d08",
        "dna_pe_4":
        "0d5eaa1611d71e781938d5b3f325a95152fb0faf4b540de10eb0b4d1ab178222",
        "dna_s_tc":
        "54ec3ad7470effa88f9a57973925601180f422703d1f64e70424087d96658f44",
        "dna_siv":
        "a191fed9df1d6b9ac09f64fc522c648505ac12def4351dae75cb7d813951e5bb",
        "id":
        "168ea5ef5edda61438a20c77c33f24e2d25536568e6d6e468ef94115d66ae72d",
        "meta":
        "605c9a8be2da54e0e88ce9c8980d5305cf80487aea513ae25e39b41136521bdd",
        "qual":
        "baf560a4288da123bc6d56542069a3b2038eb0e658bdf32ea0b86bd4bcb34972"})
# the committed mesh fixtures [mesh] decodes (fqsqueezer_tpu_torch/
# testdata/mesh, written by the reference's mesh writer at -gs 5): name ->
# the sha256 of the reference's sequential decode of each output file
MESH_FIXTURES = (
    ("gs5_se_dp4tp2",
     ("c578fc179faec1e7da466d40d26ea5998f198379b0a0d6121158544514c99e9f",)),
    ("gs5_pe_dp2tp1",
     ("606abcfef96c1adbc486c4b2b61d309080c0dbab78c0d602b4cdb6fe99da0d90",
      "47fb693487e5e1270b3ae23f4b089c1e0ba08bc131e7dcb53c4cbd76a5c7f139")),
)
MESH_DIR = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "mesh")
# [mesh_write]: the -gs 5 mesh fixtures written on the card, with the
# reference writer's inputs (tests/test_torch_mesh.py's SPECS, mesh_params
# at "gs5" and GS5_GROUP_MEM, copied here: the card has no JAX): (name,
# kind, reads or pairs, dp, tp, -qm, -im, group budget in bytes); the
# corpora are _corpus's and _pe_corpus's
MESH_WRITE_FIXTURES = (
    ("gs5_se_dp4tp2", "se", 3000, 4, 2, "illumina_8", "lossless", 1 << 20),
    ("gs5_pe_dp2tp1", "pe", 600, 2, 1, "none", "none", 512 << 10),
)
# and the CLI's e -dp/-tp at full width, each archive decoded by its d and
# held to the input (BYTE-EXACT): (reads or pairs, flags)
MESH_WRITE_CLI = (
    (FULL_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                  "-dp", "4", "-tp", "2")),
    (10_000, ("-p", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5", "-dp",
              "2", "-tp", "1")),
)
# [mesh_legacy] (a): the committed fixtures of every header a JAX mesh
# writer stores (fqsqueezer_tpu_torch/testdata/mesh_legacy, written by the
# reference's mesh writer; tests/test_torch_mesh_legacy.py's SPECS and
# fixture_params, copied here: the card has no JAX): (name, header
# generation (None: today's), kind, order, -qm, -im, (reads or pairs, read
# length, seed), dp, tp, group budget in bytes (None: the default),
# mesh_route_sb). Inputs: utils.corpus of a 20,000-base genome, or
# write_repeat_corpus with MESH_LEGACY_DROP_ODD for route_drop_dp2tp4, whose
# decode fails as the reference's does (MESH_LEGACY_DROP_ERROR); the
# decode digests are the fixtures' SHA256SUMS
MESH_LEGACY_DIR = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata",
                               "mesh_legacy")
MESH_LEGACY_FIXTURES = (
    ("h0_se_dp2tp2", "H0", "se", "o", "lossless", "lossless", (40, 48, 31),
     2, 2, 1, 0),
    ("h0_pe_dp2tp1", "H0", "pe", "o", "lossless", "lossless", (40, 48, 33),
     2, 1, None, 0),
    ("h0_sorted_dp2tp1", "H0", "se", "s", "illumina_8", "none",
     (96, 48, 35), 2, 1, None, 0),
    ("h1_se_dp2tp1", "H1", "se", "o", "lossless", "lossless", (80, 40, 37),
     2, 1, 1, 0),
    ("h1_pe_dp2tp1", "H1", "pe", "o", "lossless", "lossless", (40, 48, 39),
     2, 1, None, 0),
    ("h4_se_dp4tp2", "H4", "se", "o", "illumina_8", "lossless",
     (160, 40, 41), 4, 2, 1, 0),
    ("h6_se_dp2tp2", "H6", "se", "o", "lossless", "lossless", (80, 32, 43),
     2, 2, 1, 0),
    ("route_se_dp2tp4", None, "se", "o", "illumina_8", "lossless",
     (64, 84, 45), 2, 4, None, 1),
    ("route_drop_dp2tp4", None, "se", "o", "illumina_8", "lossless",
     (97, 89, 1), 2, 4, None, 1),
)
MESH_LEGACY_DROP_ODD = (14, 15, 30, 31, 60, 61, 62, 63, 92, 93, 94, 95, 96)
MESH_LEGACY_DROP_ERROR = "payload checksum mismatch (seq mesh decode)"
# (b): the 100k corpus round-tripped at full width: (header generation
# (None: today's), mesh_route_sb, flags)
MESH_LEGACY_FULL = (
    ("H0", 0, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5", "-dp",
               "4", "-tp", "2")),
    ("H4", 0, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5", "-dp",
               "4", "-tp", "2")),
    (None, 1, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5", "-dp",
               "2", "-tp", "4")),
)
# [mesh_ranks]: the JAX package's mesh decode of route_drop_dp2tp4
# (fqsqueezer_tpu.parallel.mesh_pipeline.decompress_file_mesh with its dp x
# tp = 8 devices, the 8 virtual CPU devices of tests/conftest.py;
# tests/test_torch_mesh_ranks.py::test_reference_mesh_decode_digests),
# which replays the writer's routed s/b exchange as the port's ranks do
MESH_RANKS_DROP = ("b494fecb39686908ebf70de3646ce3521965c761018a183a2dd32bad"
                   "1d71e33d")
# the CPU fixtures of testdata/mesh (tests/test_torch_mesh.py's SPECS and
# mesh_params at "cpu", copied here: the card has no JAX): (name, kind,
# (reads or pairs, read length, seed), dp, tp, order, -qm, -im); inputs
# from _make_fastq and _make_pe_pair; snap_dp2tp1 at a 64 KiB group budget
# with its snapshots
MESH_CPU_FIXTURES = (
    ("se_dp4tp2", "se", (192, 72, 13), 4, 2, "o", "lossless", "lossless"),
    ("pe_dp2tp1", "pe", (96, 64, 17), 2, 1, "o", "none", "none"),
    ("sorted_dp2tp1", "se", (96, 72, 19), 2, 1, "s", "illumina_8", "none"),
    ("snap_dp2tp1", "se", (128, 72, 29), 2, 1, "o", "illumina_8",
     "lossless"),
)
MESH_SNAP_GROUP_MEM = 64 << 10
# the 100k corpus on 2 ranks sharing the card, against the one-process
# writer's archive of the same input; and where torch sees 2 cards or more,
# on min(cards, 4) ranks over NCCL, one card each, timed beside one process
MESH_RANKS_SHARED = ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                     "-dp", "2", "-tp", "2")
MESH_RANKS_CARDS = ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                    "-dp", "4", "-tp", "2")
# the CLI's one-process route for the earlier mesh phases: on a machine
# with dp cards or more the CLI's default runs a mesh on ranks
ONE_CARD = ("--device", "cuda:0")
# (N, r_pl, L, grown tables, short word stream) of the K2 checks on encoded
# random batches
K2_SHAPES = ((8, 2, 104, False, False), (8, 2, 40, False, True),
             (256, 2, 104, True, False), (256, 1, 40, True, True),
             (2048, 2, 104, False, False), (2048, 2, 104, True, True))
# (N, r_pl, L) of the K2 check on adversarial tables
K2_ADVERSARIAL = (256, 2, 104)
# (N, r_pl, L) of the K2 checks on sorted batches (shared prefixes)
K2_LCP_SHAPES = ((8, 3, 40), (256, 2, 104), (1024, 4, 104), (2048, 2, 264))
# (N, pairs a lane, L) of the K2 checks on paired-end batches whose
# anchored rows copy their anchors (dna_batches.pe_row_inputs)
K2_PE_SHAPES = ((8, 5, 40), (8, 5, 104), (1024, 2, 104))
# The older writers' headers (params.HEADER_GENERATIONS: H0 the first
# writer's batch-frozen table_* tables, ctx v1, id codec v1; H5 and H6 the
# row-global ktable_* tables, H6 with ctx v2 and the rough rescue):
# (generation, reads, or pairs with -p, flags, the JAX writer's archive
# sha256, the JAX decoder's FASTQ sha256 or None where the decode must be
# the input itself). The first row is the H0 table family's timed batch,
# the second its sorted one, the fourth the ktable family's.
LEGACY = (
    ("H0", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "3190cb6ceeb5bb334e22129227dfa41da8d5671dd4831064b139d8fc27367d6d",
     None),
    ("H0", DIGEST_READS, ("-s", "-om", "s", "-qm", "o", "-im", "n", "-gs",
                          "5"),
     "8381ecb50a37e4a9be45eff91e7da7a367ce59393dc6350b7af0488ebf76db9b",
     "647a3c522cdc29f6b130a4d5437b90e8268c4e27d70fade6afcc2bd646416fb3"),
    ("H5", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "a5af217161531853091a6728794f518a6851c451b79eb2ece311e407b74bbb91",
     None),
    ("H6", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "6d127151b38871a25f4c167bc1e617df7eb1935fa213c3210c04a6e658d66d21",
     None),
    ("H6", 10_000, ("-p", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5"),
     "22d26f425c6053d2a22a5fb2546084e374f3f1682e077b25033d182fe85eb0e3",
     None),
    ("H1", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "85f2719bc0e6f904956f922a024fa309188ed1513c896d038ce78d7b078f9359",
     None),
    ("H1", DIGEST_READS, ("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs",
                          "5"),
     "2afeee1f471905001ae1a1ef9cbd8ffb066c41875d283370f9c59aa45dfdfad0",
     "6e2c51b2dbc600760a3454249ec6c317c2bf7ccbc7cfe4ad6f0da2ddc8bda21e"),
    ("H2", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "24b044fa8a03d82f37ca15fbd9bcc84c17ab855bf19aa0c9cfcb428b60eb68dd",
     None),
    ("H3", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "081b9ad163fbb3d234e1f1d70686da1e731b5b9f0476489a3097e8de9983cab8",
     None),
    ("H4", DIGEST_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                          "5"),
     "513aa4dc7b2d94cadab6386f86741910b93f26344b3b4d686c9a84e239386a11",
     None),
    ("H4", 10_000, ("-p", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5"),
     "6facdf57f825aa64612285f808eaa3e114f0bcf1ad5ddd17e43610cf6c896eeb",
     None),
)
# the LEGACY rows whose real batch [k2_legacy] times, by the name of K2's
# instantiation on it (H3's takes H2's, the PE rows' their SE ones')
LEGACY_TIMED = {0: "H0", 1: "H0 sorted", 2: "H5", 3: "H6", 5: "H1",
                6: "H1 sorted", 7: "H2", 9: "H4"}
# the full-width round trips (generation, reads, flags, archive sha256):
# compress and decode timed, the decode BYTE-EXACT
LEGACY_FULL = (
    ("H0", FULL_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                        "5"),
     "7d9d1073d1d52bcb84db13bcf1247a6b45562e07f97e578b0efa3a2c4e0faa36"),
    ("H6", FULL_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                        "5"),
     "ba26cf43a41cfb5ccb15afefc124095e05b1ae73be6f76425e040060d01e7c2a"),
    ("H1", FULL_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                        "5"),
     "deed7dda51920629a7b55d56fcb791853539dd56948c5a8d905e0bbc1f273ed1"),
    ("H4", FULL_READS, ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs",
                        "5"),
     "9ba3640d85ba8b2f1ceff3c24781b10d53c3b5750181fae3a6f56aad41690312"),
)
# the K2 instantiations the older headers add, checked against the plain
# row step on encoded random batches: (name, generation (None: today's
# header), batch-frozen tables, other knobs); (N, r_pl, L, grown tables,
# short word stream) of each check, and (N, r_pl, L) of a sorted batch
K2_LEGACY = (("table cells, batch-frozen (H0)", "H0", False, {}),
             ("ktable cells, row update (H5)", "H5", False, {}),
             ("ktable cells, row update, rough (H6)", "H6", False, {}),
             ("ktable cells, batch-frozen", "H6", True, {}),
             ("K2 cells, batch-frozen", None, True, {}),
             ("K2 cells, row update, the older knobs", None, False,
              {"ctx_v": 1, "rough": 0, "let_pb2": 0, "mix_w": 0,
               "prefix_ramp": False, "pmer_gate": 20, "repair_iters": 3}),
             ("table cells, local_* tables (H2)", "H2", False,
              {"local_log2_cells": 16}),
             ("table cells, local_* tables and DNA deltas (H1)", "H1",
              False, {"local_log2_cells": 16}),
             ("ktable cells, klocal_* tables (H4)", "H4", False,
              {"local_log2_cells": 16}),
             ("ktable cells, klocal_* tables and DNA deltas", "H4", False,
              {"local_log2_cells": 16, "local_model_inc": 8}),
             ("K2 cells, klocal_* tables and DNA deltas", None, True,
              {"local_log2_cells": 16, "local_model_inc": 8}))
K2_LEGACY_SHAPES = ((8, 2, 104, False, False), (256, 2, 40, True, True),
                    (2048, 2, 104, False, False))
K2_LEGACY_SORTED = (256, 2, 104)
# the K2_LEGACY_SHAPES entry on which each kind is also timed, with its
# chain floor and bound
K2_LEGACY_TIMED_SHAPE = (2048, 2, 104, False, False)


# [knobs]: the header knobs no CLI flag sets — dna_sorted_ctx (sorted-mode
# position buckets), dna_pe_pos_ctx (read2's coordinates on the anchored
# rows) and dna_canon 0 with dna_row_global 1 (row-global context-keyed
# table_* cells, claim rounds 0). (a) The committed fixtures of
# testdata/knobs (KNOB_FIXTURES: tests/test_torch_knobs.py's SPECS and
# knob_params, copied here: the card has no JAX): (name, flags, knobs,
# (reads or pairs, read length, seed, genome bases), mesh dp x tp or None);
# the decode digests are the fixtures' SHA256SUMS, the JAX decoder's
KNOBS_DIR = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "knobs")
_SORTED_CTX = {"dna_sorted_ctx": 1}
_PE_POS = {"dna_pe_pos_ctx": 1}
_CANON0_RG = {"dna_canon": 0, "dna_row_global": 1, "dna_claim_rounds": 0}
KNOB_FIXTURES = (
    ("sorted_ctx", ("-s", "-om", "s", "-qm", "8", "-im", "n"), _SORTED_CTX,
     (24, 48, 61, 20_000), None),
    ("pe_pos", ("-p", "-om", "o", "-qm", "n", "-im", "n"), _PE_POS,
     (24, 48, 63, 400), None),
    ("pe_pos_sorted", ("-p", "-om", "s", "-qm", "n", "-im", "n"),
     {**_PE_POS, **_SORTED_CTX}, (24, 48, 65, 400), None),
    ("canon0_rg", ("-s", "-om", "o", "-qm", "8", "-im", "n"), _CANON0_RG,
     (24, 48, 67, 20_000), None),
    ("canon0_rg_r2", ("-s", "-om", "o", "-qm", "8", "-im", "n"),
     {**_CANON0_RG, "dna_claim_rounds": 2}, (24, 48, 69, 20_000), None),
    ("canon0_rg_sorted", ("-s", "-om", "s", "-qm", "8", "-im", "n"),
     _CANON0_RG, (24, 48, 71, 20_000), None),
    ("canon0_rg_dp2tp2", ("-s", "-om", "o", "-qm", "8", "-im", "n"),
     _CANON0_RG, (48, 48, 73, 20_000), (2, 2)),
)
# (b) the knobs at full width (-gs 5, the CLI's lanes, 2^22-bucket tables):
# (name, knobs, reads or pairs, flags, the JAX writer's archive sha256,
# the JAX decoder's FASTQ sha256 of each output file), the bench corpus
# (_corpus) or bench pairs (_pe_corpus); the larger run of each name is
# timed (the smaller one, run first, warms it up)
KNOBS_FULL = (
    ("sorted_ctx", _SORTED_CTX, DIGEST_READS,
     ("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs", "5"),
     "4dffd0ecf274aadd68ed48dd4fabcd49e6c726cc422336fd2575e8acd5b91f36",
     ("6e2c51b2dbc600760a3454249ec6c317c2bf7ccbc7cfe4ad6f0da2ddc8bda21e",)),
    ("sorted_ctx", _SORTED_CTX, FULL_READS,
     ("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs", "5"),
     "9fce84540ec137238335de3b815c0696531891e2cba4b8296a10e2eb18d3c4cf",
     ("9d9d844128eccc4f0af2c23bf0601d16f67007b52775c9ce40c2f98dfb8029b4",)),
    ("canon0_rg", _CANON0_RG, DIGEST_READS,
     ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5"),
     "59eee1377476470131671a8a471b6209628e5ad5495be97221900c32eb92a455",
     ("ea7c1942f71dfd492a10d527c271e8a2ea52519e07f3de75ecfd4a52d3c12fcb",)),
    ("canon0_rg", _CANON0_RG, FULL_READS,
     ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5"),
     "3f04f1b86e0e7fe708c04d0c6f839d9c1daf2b9a8f0bf0a04b31fef245acda90",
     ("a00dacd9b85ce07c6092b65118fbb9a490edd14d31739630fb5f9d17a1ab999a",)),
    ("pe_pos", _PE_POS, 10_000,
     ("-p", "-om", "o", "-qm", "n", "-im", "n", "-gs", "5"),
     "9002f04814649232f27c31f8bb733a802931a8bb264b15f440fa80b208114aab",
     ("723617e0d0d8234c2b1aca12f6fffebef300566b8c238590698e61877d846c49",
      "3984e9cf71b1b03e6e764b91bbb3d45905a7998165ca861eebda56669a358394")),
    ("pe_pos", _PE_POS, 50_000,
     ("-p", "-om", "o", "-qm", "n", "-im", "n", "-gs", "5"),
     "a69043711d09ae6b5747d63a467ac931e2dfec7e084effa862814cb5260f02f4",
     ("74360fee0d28078bc3d72c31b242610f2a095b8909f1d07e458345c29b809c27",
      "3d3abe48c3eb34cf506c680fd70804ea28559f210091f362f0e57bdf8a5b54f8")),
    ("pe_pos_sorted", {**_PE_POS, **_SORTED_CTX}, 10_000,
     ("-p", "-om", "s", "-qm", "n", "-im", "n", "-gs", "5"),
     "7af649452495b8f9228859d86bb06c7aa9b1da4ebe24dbf5879413983e541d60",
     ("6a0234e3ae3f9751afda88fbb6f9ff1ccd4356d9782f6c7ffbf21356f5b4d290",
      "caaccc5c106126f6e4e2d13c54b91866159e8c7b56d69beec5716a5c97d32f6e")),
)
# (N, r_pl, L) of the K2 checks of the sorted-mode position map on random
# sorted batches, and (N, pairs a lane, L) of the paired-end map's on
# random PE batches (dna_batches.pe_row_inputs)
K2_POS_SORTED_SHAPES = ((8, 3, 40), (256, 4, 104))
K2_POS_PE_SHAPES = ((8, 5, 40), (256, 2, 104))


def bench_params():
    """bench.py's primary row: e -s -om o -qm 8 -im n -gs 5, 2048 lanes
    (the Params the CLI makes of BENCH_ROW)."""
    from fqsqueezer_tpu_torch.params import (DnaMode, IdMode, Params,
                                             QualityMode)

    p = Params()
    p.genome_size = 5
    p.adjust_kmer_sizes()
    p.dna_mode = DnaMode.SE_ORIGINAL
    p.quality_mode = QualityMode.ILLUMINA_8
    p.id_mode = IdMode.NONE
    p.verbosity = 0
    p.auto_tune_lanes()
    return p


def _ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda is not "
                         "available); this check needs one card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    return card


def phase_build():
    from fqsqueezer_tpu_torch.ops import _build

    t0 = time.time()
    out_dir = _build.build(verbose=True)
    _build.kernels()
    print(f"[build] {os.path.relpath(out_dir, REPO)} in "
          f"{time.time() - t0:.2f} s")


def _cuda_grid(seed, T, N):
    import torch

    from fqsqueezer_tpu_torch.utils.rans_grids import random_grid

    f, c = random_grid(seed, T, N, SB)
    return torch.from_numpy(f).cuda(), torch.from_numpy(c).cuda()


def _err(got, want):
    """Max abs difference over the (words, emits, states) of one walk."""
    import torch

    return max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got, want) if g.numel()), default=0)


def _bound_ms(T, N):
    """(ms, 'bytes' | 'operations'): the least time the card could take for
    one walk of an int32 [T, N] grid pair — f and c read once, u16 words and
    u8 emit flags written once, the states (u32 carried in int64) in and
    out."""
    nbytes = T * N * (4 + 4 + 2 + 1) + N * (8 + 8)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = T * N * K1_OPS_PER_SLOT / INT_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_k1():
    """K1 == its plain version, exact, on every shape; returns the numbers
    of the kernels line."""
    import numpy as np
    import torch

    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.utils.rans_grids import adversarial_grid

    worst = 0
    for T, N in K1_SHAPES:
        fd, cd = _cuda_grid(T * 7 + N, T, N)
        init = rans.rans_initial_states(N, "cuda")
        got = rans.rans_encode_walk(fd, cd, SB, init)
        torch.cuda.synchronize()
        worst = max(worst, _err(got, rans.rans_encode_walk_plain(
            fd, cd, SB, init)))
        # the group encode (kernel + compaction) against the CPU path
        bounds = np.linspace(0, T, 5).astype(np.int64)
        rb = np.full((rans.GROUP_MAX_BATCHES + 1,), T, np.int64)
        rb[:bounds.size] = bounds
        rb = torch.from_numpy(rb)
        gw, gn, gs = rans.rans_encode_group(fd, cd, SB, rb.cuda())
        pw, pn, ps = rans.rans_encode_group(fd.cpu(), cd.cpu(), SB, rb)
        if gw.shape != pw.shape:
            raise RuntimeError(f"K1 group encode at T={T} N={N}: "
                               f"{gw.numel()} words, plain {pw.numel()}")
        worst = max(worst, _err((gw.cpu(), gn.cpu(), gs.cpu()),
                                (pw, pn, ps)))
        if worst != 0:
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"T={T} N={N}: max abs err {worst}")
    fa, ca, ia = (torch.from_numpy(a).cuda()
                  for a in adversarial_grid(7, *K1_ADVERSARIAL, SB))
    worst = max(worst, _err(rans.rans_encode_walk(fa, ca, SB, ia),
                            rans.rans_encode_walk_plain(fa, ca, SB, ia)))
    if worst != 0:
        raise RuntimeError(f"K1 disagrees with its plain version on the "
                           f"adversarial grid: max abs err {worst}")
    # the flush as the main path launches it: one launch for its three
    # streams == the plain walk of each == three single walks
    flush = [_cuda_grid(11 + i, T, N) for i, (T, N) in enumerate(K1_FLUSH)]
    before = rans.K1_LAUNCHES
    multi = rans.rans_encode_walks(flush, SB)
    if rans.K1_LAUNCHES != before + 1:
        raise RuntimeError("the three-stream walk did not take one launch")
    for (f, c), got in zip(flush, multi):
        init = rans.rans_initial_states(f.shape[1], "cuda")
        worst = max(worst,
                    _err(got, rans.rans_encode_walk_plain(f, c, SB, init)),
                    _err(got, rans.rans_encode_walk(f, c, SB, init)))
    if worst != 0:
        raise RuntimeError(f"the three-stream launch disagrees with the "
                           f"plain walks or with three single walks: max "
                           f"abs err {worst}")

    T, N = K1_TIMED
    fd, cd = flush[1]
    init = rans.rans_initial_states(N, "cuda")
    rb = torch.full((rans.GROUP_MAX_BATCHES + 1,), T, dtype=torch.int64,
                    device="cuda")
    rb[0] = 0
    ms = _ms(lambda: rans.rans_encode_walk(fd, cd, SB, init), 20)
    plain_ms = _ms(lambda: rans.rans_encode_walk_plain(fd, cd, SB, init), 3)
    group_ms = _ms(lambda: rans.rans_encode_group(fd, cd, SB, rb), 20)
    multi_ms = _ms(lambda: rans.rans_encode_walks(flush, SB), 20)
    singles_ms = _ms(lambda: [rans.rans_encode_walks([g], SB)
                              for g in flush], 20)
    bound_ms, bound_by = _bound_ms(T, N)
    print(f"[k1] exact on {len(K1_SHAPES)} shapes (walk + group encode), "
          f"the adversarial grid and the three-stream launch; T={T} N={N}: "
          f"walk {ms:.4f} ms ({ms / T * 1e6:.1f} ns a row), plain torch "
          f"{plain_ms:.2f} ms, group encode (walk + compaction) "
          f"{group_ms:.4f} ms, byte bound {bound_ms:.4f} ms; three streams "
          f"{K1_FLUSH}: one launch {multi_ms:.4f} ms, three launches "
          f"{singles_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "group_encode_ms": group_ms,
            "three_stream_ms": multi_ms, "three_launches_ms": singles_ms}


def _corpus(n_reads):
    """(bench corpus path, archive path) for n_reads reads; the corpus is
    written once a run."""
    from fqsqueezer_tpu_torch.tools.bench_gpu import corpus
    from fqsqueezer_tpu_torch.utils.corpus import write_fastq_corpus

    src = corpus(os.path.join(WORK, f"bench_{n_reads}.fastq"),
                 write_fastq_corpus, n_reads)
    return src, os.path.join(WORK, f"bench_{n_reads}.fqst")


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _n_groups(arc, n_lanes):
    """Group flushes an archive holds (the port's own reader)."""
    from fqsqueezer_tpu_torch.archive import ArchiveReader

    rd = ArchiveReader(arc)
    n = 0
    try:
        while rd.read_group(n_lanes) is not None:
            n += 1
    finally:
        rd.close()
    return n


def _compress(n_reads):
    """(stats, sha256, seconds, K1 launches, group flushes) of one
    compress_file on the card (no device named: the default), the input
    parsed beforehand."""
    import torch

    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.io import fastq
    from fqsqueezer_tpu_torch.ops import rans

    src, arc = _corpus(n_reads)
    data = fastq.read_fastq(src)
    p = bench_params()
    torch.cuda.synchronize()
    rans.K1_LAUNCHES = 0
    t0 = time.time()
    stats = pipeline.compress_file(p, src, arc, data=data)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = rans.K1_LAUNCHES
    return stats, _sha256(arc), dt, launches, _n_groups(arc, p.n_lanes)


def phase_digest():
    """The 20k corpus through the CLI, as a user runs it (no --device: the
    CLI takes the card and prints it at -v 1)."""
    import torch

    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.ops import rans

    src, arc = _corpus(DIGEST_READS)
    rans.K1_LAUNCHES = 0
    t0 = time.time()
    rc = cli.main(["e", *BENCH_ROW, "-v", "1", "-out", arc, src])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = rans.K1_LAUNCHES
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    groups = _n_groups(arc, bench_params().n_lanes)
    if launches < groups or launches < 1:
        raise RuntimeError(f"K1 launched {launches} times in a compress of "
                           f"{groups} group flushes (want one a flush)")
    sha = _sha256(arc)
    if sha != DIGEST_20K:
        raise RuntimeError(f"20k archive sha256 {sha} != reference "
                           f"{DIGEST_20K}")
    print(f"[digest] {DIGEST_READS} reads through the CLI: sha256 {sha} == "
          f"reference; {os.path.getsize(arc)} B, K1 launches {launches} in "
          f"{groups} flush(es), {dt:.2f} s")


def phase_full():
    import torch

    _compress(FULL_READS)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    stats, sha, dt, launches, groups = _compress(FULL_READS)
    peak = torch.cuda.max_memory_allocated()
    if sha != DIGEST_100K:
        raise RuntimeError(f"100k archive sha256 {sha} != reference "
                           f"{DIGEST_100K}")
    if launches < groups or launches < 1:
        raise RuntimeError(f"K1 launched {launches} times in the main "
                           f"path's {groups} group flushes")
    print(f"[full] {stats['n_reads']} reads: {stats['n_reads'] / dt:.1f} "
          f"reads/s, {stats['bits_per_base']:.4f} bits/base, wall "
          f"{dt:.3f} s, peak CUDA memory {peak / 2**30:.3f} GiB, "
          f"sha256 == reference, K1 launches {launches} in {groups} "
          f"flush(es)")
    return launches


# K4 and K5 launches of the decodes whose counts _check_scans held
SCAN_LAUNCHES = {"K4": 0, "K5": 0}


def _launch_counts():
    """(K3, K2) launches since the last _reset_launches."""
    from fqsqueezer_tpu_torch.streams import dna, quality

    return quality.K3_LAUNCHES, dna.K2_LAUNCHES


def _reset_launches():
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.streams import dna, ids, meta, quality

    rans.K1_LAUNCHES = quality.K3_LAUNCHES = dna.K2_LAUNCHES = 0
    ids.K4_LAUNCHES = meta.K5_LAUNCHES = 0
    dna.K2_POS_LAUNCHES = dict.fromkeys(dna.K2_POS, 0)


def _check_scans(arc, what, k4=None, k5=None):
    """K5 once a batch (of each dp shard on a mesh) and K4 as often where
    the archive has ids and never without, in the decode just run (the
    counts since the last _reset_launches, or k4 and k5 where given: the
    ranks' sums). Every batch runs one scan of each, so the counts also
    show that no batch ran a plain scan. Adds them to SCAN_LAUNCHES;
    returns (K4, K5)."""
    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.streams import ids, meta

    p, batches, *_ = _mesh_rows(arc)
    k5_want = p.mesh_dp * batches
    k4_want = k5_want if pipeline.make_configs(p)[3] is not None else 0
    got = (ids.K4_LAUNCHES if k4 is None else k4,
           meta.K5_LAUNCHES if k5 is None else k5)
    if got != (k4_want, k5_want):
        raise RuntimeError(f"{what}: K4 launched {got[0]} times (want "
                           f"{k4_want}), K5 {got[1]} (want {k5_want}) for "
                           f"{batches} batches of {p.mesh_dp} shard(s)")
    SCAN_LAUNCHES["K4"] += got[0]
    SCAN_LAUNCHES["K5"] += got[1]
    return got


def _check_decode_launches(arc, has_quality, what):
    """K3 once a batch with a quality stream and never without one, K2 once
    a read row, K4 and K5 as _check_scans says, in the decode just run;
    returns (K3, K2) launches."""
    _check_scans(arc, what)
    k3, k2 = _launch_counts()
    batches, rows = _batches_and_rows(arc)
    if k3 != (batches if has_quality else 0) or k2 != rows:
        raise RuntimeError(f"{what}: K3 launched {k3} times for {batches} "
                           f"batches (quality stream: {has_quality}), K2 "
                           f"{k2} times for {rows} read rows")
    return k3, k2


def phase_modes():
    """Every other SE original-order mode: the 20k corpus through the CLI,
    the 100k corpus through pipeline (warm-up + timed run). Returns the K3
    launches of each mode's decode, by symbol count."""
    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.io import fastq
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.streams import quality
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed, timed_peak

    k3 = {}
    for tag, flags, want, want_dec in MODES_20K:
        src, _ = _corpus(DIGEST_READS)
        arc = os.path.join(WORK, f"{tag}_{DIGEST_READS}.fqst")
        out = os.path.join(WORK, f"{tag}_{DIGEST_READS}.dec.fastq")
        _reset_launches()
        rc, dt = timed(lambda: cli.main(["e", *flags, "-v", "0", "-out",
                                          arc, src]))
        sha = _sha256(arc)
        if rc != 0 or sha != want:
            raise RuntimeError(f"{tag}: the CLI's e returned {rc}, archive "
                               f"sha256 {sha} != reference {want}")
        _reset_launches()
        rc, ddt = timed(lambda: cli.main(["d", "-v", "0", "-out", out,
                                           arc]))
        dsha = _sha256(out)
        if rc != 0 or dsha != want_dec:
            raise RuntimeError(f"{tag}: the CLI's d returned {rc}, FASTQ "
                               f"sha256 {dsha} != reference decoder's "
                               f"{want_dec}")
        n3, n2 = _check_decode_launches(arc, True, tag)
        k3[pipeline.make_configs(cli.parse_args(
            ["e", *flags, src]))[1].n_sym] = n3
        print(f"[modes] {DIGEST_READS} reads `{' '.join(flags)}` through "
              f"the CLI: archive sha256 == reference, decode sha256 == "
              f"reference decoder; e {dt:.2f} s, d {ddt:.2f} s; K3 "
              f"launches {n3}, K2 {n2}")
    for tag, flags, want, want_dec in MODES_100K:
        src, _ = _corpus(FULL_READS)
        arc = os.path.join(WORK, f"{tag}_{FULL_READS}.fqst")
        out = os.path.join(WORK, f"{tag}_{FULL_READS}.dec.fastq")
        data = fastq.read_fastq(src)

        def compress():
            return pipeline.compress_file(cli.parse_args(
                ["e", *flags, "-v", "0", src]), src, arc, data=data)

        compress()                                 # warm-up
        stats, dt, peak = timed_peak(compress)
        sha = _sha256(arc)
        if sha != want:
            raise RuntimeError(f"{tag}: 100k archive sha256 {sha} != "
                               f"reference {want}")
        p = cli.parse_args(["e", *flags, src])
        qcfg = pipeline.make_configs(p)[1]
        pipeline.decompress_file(Params(), arc, out)   # warm-up
        _reset_launches()
        dstats, ddt, dpeak = timed_peak(
            lambda: pipeline.decompress_file(Params(), arc, out))
        n3, n2 = _check_decode_launches(arc, qcfg is not None, tag)
        dsha = _sha256(out)
        if dsha != (want_dec or _sha256(src)):
            raise RuntimeError(f"{tag}: decoded 100k FASTQ sha256 {dsha} != "
                               + ("the input's" if want_dec is None else
                                  f"reference decoder's {want_dec}"))
        if qcfg is not None:
            k3[qcfg.n_sym] = n3
        n = stats["n_reads"]
        print(f"[modes] {n} reads `{' '.join(flags)}` ({p.n_lanes} lanes): "
              f"compress {n / dt:.1f} reads/s (wall {dt:.3f} s, peak "
              f"{peak:.3f} GiB), {stats['bits_per_base']:.4f} bits/base, "
              f"archive sha256 == reference; decode "
              f"{dstats['n_reads'] / ddt:.1f} reads/s (wall {ddt:.3f} s, "
              f"peak {dpeak:.3f} GiB), "
              + ("the input's bytes" if want_dec is None else
                 "sha256 == reference decoder")
              + f"; K3 launches {n3}, K2 {n2}")
    if set(k3) != set(quality.K3_SYM) - {8}:
        raise RuntimeError(f"K3 ran for symbol counts {sorted(k3)}")
    return k3


def phase_sorted():
    """Sorted order, the CLI's default path: the 20k corpus through the
    CLI's e (only -gs 5) and d, the 100k corpus at the bench's sorted row
    through pipeline (warm-up + timed run), and the 20k corpus streamed.
    Returns the launches of the timed 100k run: (K1 in the compress, K3
    and K2 in the decode)."""
    import torch

    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.io import fastq
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed, timed_peak

    # (a) the CLI's defaults
    flags, want, want_dec = SORTED_CLI
    src, _ = _corpus(DIGEST_READS)
    arc = os.path.join(WORK, f"sorted_cli_{DIGEST_READS}.fqst")
    out = os.path.join(WORK, f"sorted_cli_{DIGEST_READS}.dec.fastq")
    _reset_launches()
    rc, dt = timed(lambda: cli.main(["e", *flags, "-v", "0", "-out", arc,
                                      src]))
    n1 = rans.K1_LAUNCHES
    sha = _sha256(arc)
    if rc != 0 or sha != want:
        raise RuntimeError(f"sorted: the CLI's e {' '.join(flags)} returned "
                           f"{rc}, archive sha256 {sha} != reference {want}")
    _reset_launches()
    rc, ddt = timed(lambda: cli.main(["d", "-v", "0", "-out", out, arc]))
    dsha = _sha256(out)
    if rc != 0 or dsha != want_dec:
        raise RuntimeError(f"sorted: the CLI's d returned {rc}, FASTQ "
                           f"sha256 {dsha} != reference decoder's {want_dec}")
    n3, n2 = _check_decode_launches(arc, True, "sorted (CLI defaults)")
    print(f"[sorted] {DIGEST_READS} reads `e {' '.join(flags)}` (the CLI's "
          f"defaults: -s -om s -qm 8 -im i, "
          f"{cli.parse_args(['e', *flags, src]).n_lanes} lanes): archive "
          f"sha256 == reference, decode sha256 == reference decoder; e "
          f"{dt:.2f} s (K1 launches {n1}), d {ddt:.2f} s (K3 launches {n3}, "
          f"K2 {n2})")

    # (b) the bench's sorted row, 100k reads
    flags, want, want_dec = SORTED_100K
    src, _ = _corpus(FULL_READS)
    arc = os.path.join(WORK, f"sorted_{FULL_READS}.fqst")
    out = os.path.join(WORK, f"sorted_{FULL_READS}.dec.fastq")
    data = fastq.read_fastq(src)

    def compress():
        return pipeline.compress_file(cli.parse_args(
            ["e", *flags, "-v", "0", src]), src, arc, data=data)

    compress()                                     # warm-up
    _reset_launches()
    stats, dt, peak = timed_peak(compress)
    k1 = rans.K1_LAUNCHES
    groups = _n_groups(arc, cli.parse_args(["e", *flags, src]).n_lanes)
    sha = _sha256(arc)
    bpb = round(stats["bits_per_base"], 4)
    if sha != want or bpb != SORTED_BITS_PER_BASE:
        raise RuntimeError(f"sorted: 100k archive sha256 {sha} (reference "
                           f"{want}), {bpb} bits/base (want "
                           f"{SORTED_BITS_PER_BASE})")
    if k1 < groups or k1 < 1:
        raise RuntimeError(f"sorted: K1 launched {k1} times in {groups} "
                           f"group flushes")
    pipeline.decompress_file(Params(), arc, out)   # warm-up
    _reset_launches()
    dstats, ddt, dpeak = timed_peak(
        lambda: pipeline.decompress_file(Params(), arc, out))
    k3, k2 = _check_decode_launches(arc, True, "sorted 100k")
    dsha = _sha256(out)
    if dsha != want_dec:
        raise RuntimeError(f"sorted: decoded 100k FASTQ sha256 {dsha} != "
                           f"reference decoder's {want_dec}")
    n = stats["n_reads"]
    print(f"[sorted] {n} reads `{' '.join(flags)}`: compress "
          f"{n / dt:.1f} reads/s (wall {dt:.3f} s, peak {peak:.3f} GiB), "
          f"{stats['bits_per_base']:.4f} bits/base, archive sha256 == "
          f"reference, K1 launches {k1} in {groups} flush(es); decode "
          f"{dstats['n_reads'] / ddt:.1f} reads/s (wall {ddt:.3f} s, peak "
          f"{dpeak:.3f} GiB), sha256 == reference decoder, K3 launches "
          f"{k3}, K2 {k2}")

    # (c) the streamed path against the in-RAM one
    src, _ = _corpus(DIGEST_READS)
    for flags in STREAMED_20K:
        shas = []
        for chunk in (0, STREAM_CHUNK):
            arc = os.path.join(WORK, f"streamed_{chunk}.fqst")
            pipeline.compress_file(
                cli.parse_args(["e", *flags, "-v", "0", src]), src, arc,
                stream_chunk_bytes=chunk)
            shas.append(_sha256(arc))
        if shas[0] != shas[1]:
            raise RuntimeError(f"sorted: the streamed archive of "
                               f"`{' '.join(flags)}` differs from the "
                               f"in-RAM one")
        print(f"[sorted] {DIGEST_READS} reads `{' '.join(flags)}` streamed "
              f"in {STREAM_CHUNK} B chunks: archive sha256 == the in-RAM "
              f"archive's")
    torch.cuda.synchronize()
    return k1, k3, k2


def _pe_corpus(n_pairs):
    """(mate 1 path, mate 2 path) of write_pe_corpus's n_pairs pairs,
    written once a run."""
    from fqsqueezer_tpu_torch.tools.bench_gpu import _WRITTEN
    from fqsqueezer_tpu_torch.utils.corpus import write_pe_corpus

    paths = tuple(os.path.join(WORK, f"pe_{n_pairs}_{k}.fastq")
                  for k in (1, 2))
    if paths not in _WRITTEN:
        write_pe_corpus(*paths, n_pairs, 100, 4_600_000, seed=42)
        _WRITTEN.add(paths)
    return paths


def phase_pe():
    """Paired-end reads: the CLI's defaults with -p (10k pairs, e and d),
    the bench's PE row (50k pairs, warm-up + timed run through pipeline),
    and the 10k pairs streamed. Returns the launches of the timed PE row:
    (K1 in the compress, K2 in the decode)."""
    import torch

    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed, timed_peak

    # (a) the CLI's defaults with -p: sorted order, -qm 8 -im i
    n_pairs, flags, want, want1, want2 = PE_CLI
    r1, r2 = _pe_corpus(n_pairs)
    arc = os.path.join(WORK, f"pe_cli_{n_pairs}.fqst")
    outs = [os.path.join(WORK, f"pe_cli_{n_pairs}.dec_{k}.fastq")
            for k in (1, 2)]
    _reset_launches()
    rc, dt = timed(lambda: cli.main(["e", *flags, "-v", "0", "-out", arc,
                                      r1, r2]))
    n1 = rans.K1_LAUNCHES
    sha = _sha256(arc)
    lanes = cli.parse_args(["e", *flags, r1, r2]).n_lanes
    if rc != 0 or sha != want or n1 < _n_groups(arc, lanes):
        raise RuntimeError(f"pe: the CLI's e {' '.join(flags)} returned "
                           f"{rc}, archive sha256 {sha} != reference {want} "
                           f"or K1 launched {n1} times")
    _reset_launches()
    rc, ddt = timed(lambda: cli.main(["d", "-v", "0", "-out", outs[0],
                                       "-out2", outs[1], arc]))
    dshas = [_sha256(o) for o in outs]
    if rc != 0 or dshas != [want1, want2]:
        raise RuntimeError(f"pe: the CLI's d returned {rc}, FASTQ sha256s "
                           f"{dshas} != reference decoder's "
                           f"{[want1, want2]}")
    n3, n2 = _check_decode_launches(arc, True, "pe (CLI defaults)")
    print(f"[pe] {n_pairs} pairs `e {' '.join(flags)}` (the CLI's defaults "
          f"with -p: -om s -qm 8 -im i, {lanes} lanes): archive "
          f"sha256 == reference, both decodes' sha256 == reference "
          f"decoder; e {dt:.2f} s (K1 launches {n1}), d {ddt:.2f} s (K3 "
          f"launches {n3}, K2 {n2})")

    # (b) the bench's PE row, 50k pairs
    n_pairs, flags, want, want1, want2 = PE_100K
    r1, r2 = _pe_corpus(n_pairs)
    arc = os.path.join(WORK, f"pe_{n_pairs}.fqst")
    outs = [os.path.join(WORK, f"pe_{n_pairs}.dec_{k}.fastq")
            for k in (1, 2)]
    p = cli.parse_args(["e", *flags, "-v", "0", r1, r2])

    def compress():
        return pipeline.compress_pe(cli.parse_args(
            ["e", *flags, "-v", "0", r1, r2]), r1, r2, arc)

    compress()                                     # warm-up
    _reset_launches()
    stats, dt, peak = timed_peak(compress)
    k1 = rans.K1_LAUNCHES
    groups = _n_groups(arc, p.n_lanes)
    sha = _sha256(arc)
    bpb = round(stats["bits_per_base"], 4)
    if sha != want or bpb != PE_BITS_PER_BASE:
        raise RuntimeError(f"pe: 100k archive sha256 {sha} (reference "
                           f"{want}), {bpb} bits/base (want "
                           f"{PE_BITS_PER_BASE})")
    if k1 < groups or k1 < 1:
        raise RuntimeError(f"pe: K1 launched {k1} times in {groups} group "
                           f"flushes")
    pipeline.decompress_file(Params(), arc, *outs)  # warm-up
    _reset_launches()
    dstats, ddt, dpeak = timed_peak(
        lambda: pipeline.decompress_file(Params(), arc, *outs))
    k3, k2 = _check_decode_launches(arc, False, "pe 100k")
    dshas = [_sha256(o) for o in outs]
    if dshas != [want1, want2]:
        raise RuntimeError(f"pe: decoded 100k FASTQ sha256s {dshas} != "
                           f"reference decoder's {[want1, want2]}")
    n = stats["n_reads"]
    print(f"[pe] {n_pairs} pairs ({n} reads) `{' '.join(flags)}` "
          f"({p.n_lanes} lanes, 2^{p.pe_log2_buckets}-bucket pair table): "
          f"compress {n / dt:.1f} reads/s (wall {dt:.3f} s, peak "
          f"{peak:.3f} GiB), {stats['bits_per_base']:.4f} bits/base, "
          f"{stats['out_bytes'] / REF_PE_BYTES:.4f} of the C++ reference's "
          f"bytes, archive sha256 == reference, K1 launches {k1} in "
          f"{groups} flush(es); decode {dstats['n_reads'] / ddt:.1f} "
          f"reads/s (wall {ddt:.3f} s, peak {dpeak:.3f} GiB), both sha256 "
          f"== reference decoder, K2 launches {k2} (one an expanded row), "
          f"K3 {k3}")

    # (c) the streamed path against the in-RAM one
    r1, r2 = _pe_corpus(PE_CLI[0])
    shas = []
    for chunk in (0, STREAM_CHUNK):
        arc = os.path.join(WORK, f"pe_streamed_{chunk}.fqst")
        pipeline.compress_pe(cli.parse_args(
            ["e", *PE_STREAMED, "-v", "0", r1, r2]), r1, r2, arc,
            stream_chunk_bytes=chunk)
        shas.append(_sha256(arc))
    if shas[0] != shas[1]:
        raise RuntimeError(f"pe: the streamed archive of "
                           f"`{' '.join(PE_STREAMED)}` differs from the "
                           f"in-RAM one")
    print(f"[pe] {PE_CLI[0]} pairs `{' '.join(PE_STREAMED)}` streamed in "
          f"{STREAM_CHUNK} B chunks: archive sha256 == the in-RAM "
          f"archive's")
    torch.cuda.synchronize()
    return k1, k2


def _same_tail(tail, full):
    """Whether the FASTQ file `tail` holds the last records of `full`."""
    with open(tail, "rb") as f, open(full, "rb") as g:
        t = f.read()
        return bool(t) and g.read().endswith(t)


def _array_shas(arrays):
    return {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in sorted(arrays.items())}


def phase_resume():
    """Group snapshots and resume, SE and PE: compress with and without
    snapshot_prefix (the archives equal, and the reference writer's), the
    group-1 snapshot's arrays held to the reference's, then one load_state
    and two decodes from group 1, each tail the full decode's tail, and the
    loaded state's arrays unchanged after them (K2 updates the tables it
    decodes against in place: the decoder must copy them)."""
    import numpy as np
    import torch

    from fqsqueezer_tpu_torch import checkpoint, cli, pipeline
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    for tag, row in (("se", RESUME_SE), ("pe", RESUME_PE)):
        n, flags, group_mem, want_arc, want_groups, want_arrays = row
        paths = (list(_pe_corpus(n)) if "-p" in flags
                 else [_corpus(n)[0]])
        arcs = [os.path.join(WORK, f"resume_{tag}_{k}.fqst") for k in (0, 1)]
        prefix = os.path.join(WORK, f"resume_{tag}")

        def compress(arc, snap):
            p = cli.parse_args(["e", *flags, "-v", "0", *paths])
            if len(paths) == 2:
                return pipeline.compress_pe(p, *paths, arc,
                                            group_mem_bytes=group_mem,
                                            snapshot_prefix=snap)
            return pipeline.compress_file(p, paths[0], arc,
                                          group_mem_bytes=group_mem,
                                          snapshot_prefix=snap)

        compress(arcs[0], None)                    # warm-up
        _, plain_dt = timed(lambda: compress(arcs[0], None))
        _, snap_dt = timed(lambda: compress(arcs[1], prefix))
        groups = _n_groups(arcs[1], cli.parse_args(
            ["e", *flags, *paths]).n_lanes)
        sha = _sha256(arcs[1])
        if sha != _sha256(arcs[0]) or sha != want_arc or groups != want_groups:
            raise RuntimeError(f"resume {tag}: the archive with snapshots "
                               f"(sha256 {sha}, {groups} groups) differs "
                               f"from the one without or from the "
                               f"reference's ({want_arc}, {want_groups})")
        snap = checkpoint.snapshot_path(prefix, 1)
        with np.load(snap) as z:
            got = _array_shas(dict(z.items()))
        if got != want_arrays:
            bad = sorted(set(got) ^ set(want_arrays)
                         | {k for k in got if got[k] != want_arrays.get(k)})
            raise RuntimeError(f"resume {tag}: group-1 snapshot arrays {bad} "
                               f"differ from the reference writer's")
        outs = [os.path.join(WORK, f"resume_{tag}_full_{k}.fastq")
                for k in (1, 2)][:len(paths)]
        pipeline.decompress_file(Params(), arcs[1], *outs)
        state = checkpoint.load_state(snap)
        t0 = time.time()
        checkpoint.save_state(state, os.path.join(WORK, "resave.npz"))
        save_dt = time.time() - t0
        tails = []
        for rep in range(2):
            tail = [os.path.join(WORK, f"resume_{tag}_tail{rep}_{k}.fastq")
                    for k in (1, 2)][:len(paths)]
            _reset_launches()
            st, dt = timed(lambda: pipeline.decompress_file(
                Params(), arcs[1], *tail, start_group=1, init_state=state))
            k3, k2 = _launch_counts()
            if not all(_same_tail(t, f) for t, f in zip(tail, outs)):
                raise RuntimeError(f"resume {tag}: decode {rep + 1} from "
                                   f"group 1 is not the full decode's tail")
            tails.append((st["n_reads"], dt, k2, k3))
        after = _array_shas(checkpoint.state_to_arrays(state))
        if after != want_arrays:
            raise RuntimeError(f"resume {tag}: the loaded state changed "
                               f"under the decodes")
        torch.cuda.synchronize()
        print(f"[resume] {tag} {n} {'pairs' if tag == 'pe' else 'reads'} "
              f"`{' '.join(flags)}`, group budget {group_mem} B: {groups} "
              f"groups; archive with snapshots == without == reference "
              f"(sha256); group-1 snapshot's {len(got)} arrays == "
              f"reference's; snapshot {os.path.getsize(snap)} B, compress "
              f"{plain_dt:.3f} s without snapshots and {snap_dt:.3f} s with "
              f"({(snap_dt - plain_dt) / groups:.3f} s a group), "
              f"save_state {save_dt:.3f} s; two decodes from group 1 of one "
              f"load_state: {tails[0][0]} reads each, the full decode's "
              f"tail, {tails[0][1]:.3f} s and {tails[1][1]:.3f} s, K2 "
              f"launches {tails[0][2]} and {tails[1][2]}; the loaded "
              f"state's arrays unchanged")


def _mesh_rows(arc):
    """(batches, K2 launches the sequential mesh decode makes: dp x the
    read rows a shard walks, expanded rows with the PE anchors, summed over
    the batches, K3 launches: dp a batch with a quality stream, reads)."""
    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.archive import ArchiveReader
    from fqsqueezer_tpu_torch.params import Params

    rd = ArchiveReader(arc)
    try:
        p = Params.load_params(rd.header_blob)
        dcfg, qcfg, mcfg, _ = pipeline.make_configs(p)
        dp, N = p.mesh_dp, p.n_lanes
        align = dp * N * mcfg.lcp_stride
        first = pipeline._first_batch(N, p.max_batch_reads, 0, align)
        batches = rows = reads = 0
        while (g := rd.read_group(N)) is not None:
            for take, _, _ in g[1]:
                batches += 1
                reads += take
                r_shard = pipeline.canonical_padded(
                    take, first, p.max_batch_reads, align) // dp
                if dcfg.pe_log2_buckets > 0:
                    r_shard = 3 * (r_shard // 2)
                rows += dp * (r_shard // N)
    finally:
        rd.close()
    return p, batches, rows, dp * batches * (qcfg is not None), reads


def phase_mesh():
    """The committed -gs 5 mesh fixtures through the CLI's d (a mesh header
    routes to the sequential mesh decode): each output's sha256 held to
    the reference's sequential decoder's, K2 launched once a read row of
    each dp shard and K3 once a shard and batch. Also the copy of the K2
    tables each shard decodes against, timed alone."""
    import torch

    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    for name, want in MESH_FIXTURES:
        arc = os.path.join(MESH_DIR, f"{name}.fqst")
        outs = [os.path.join(WORK, f"{name}_{k}.fastq")
                for k in (1, 2)][:len(want)]
        out_args = ["-out", outs[0]] + (["-out2", outs[1]]
                                        if len(outs) == 2 else [])
        # one decode, its first call's costs included (the fixtures are
        # small: the time is no throughput figure)
        _reset_launches()
        rc, dt = timed(lambda: cli.main(["d", *ONE_CARD, "-v", "0",
                                         *out_args, arc]))
        k3, k2 = _launch_counts()
        p, batches, rows, k3_want, reads = _mesh_rows(arc)
        shas = [_sha256(o) for o in outs]
        if rc != 0 or shas != list(want):
            raise RuntimeError(f"mesh {name}: the CLI's d returned {rc}, "
                               f"sha256 {shas} != the reference's "
                               f"{list(want)}")
        if k2 != rows or k3 != k3_want:
            raise RuntimeError(f"mesh {name}: K2 launched {k2} times for "
                               f"{rows} shard rows, K3 {k3} (want "
                               f"{k3_want})")
        _check_scans(arc, f"mesh {name}")
        dcfg = pipeline.make_configs(p)[0]
        st = pipeline.state_create(dcfg, None, None, "cuda").dna
        clone_ms = _ms(lambda: (st.s_tc.clone(), st.b_tc.clone()), 20)
        print(f"[mesh] {name} ({p.mesh_dp}x{p.mesh_tp} mesh, {p.n_lanes} "
              f"lanes, {reads} reads in {batches} batches, a small "
              f"fixture): the CLI's d {dt:.3f} s (first call), "
              f"sha256 == the reference's sequential decode; K2 launches "
              f"{k2} (dp x shard rows, {k2 / batches:.1f} a batch), K3 "
              f"{k3}; copy of the 2 x {tuple(st.s_tc.shape)} K2 tables "
              f"{clone_ms:.4f} ms a shard and batch")
    torch.cuda.synchronize()


def _mesh_fixture_params(kind, qm, im):
    """The Params the -gs 5 mesh fixtures were written with
    (tests/test_torch_mesh.py's mesh_params(.., "gs5")): the CLI's -gs 5
    geometry with 16 lanes and 2048-read (SE) or 256-read (PE) batches,
    original order."""
    from fqsqueezer_tpu_torch.params import (DnaMode, IdMode, Params,
                                             QualityMode)

    p = Params()
    p.genome_size = 5
    p.adjust_kmer_sizes()
    p.dna_mode = DnaMode.SE_ORIGINAL if kind == "se" else DnaMode.PE_ORIGINAL
    p.quality_mode = QualityMode(qm)
    p.id_mode = IdMode(im)
    p.n_lanes = 16
    p.verbosity = 0
    p.max_batch_reads = 2048 if kind == "se" else 256
    return p


def _encoders_on_card():
    """The single-step encoders (pipeline._encode_batch, and
    sharded.sharded_encode at dp 4 x tp 2 with 53 of 64 reads) on a tiny
    batch (__graft_entry__'s configuration: 8 lanes, 2^12-bucket tables,
    lossless qualities and ids), on the card and on the CPU: every
    stream's words, counts and states and every array of the new state
    equal, each call one K1 launch on the card. Returns the calls
    checked."""
    import numpy as np
    import torch

    from fqsqueezer_tpu_torch import checkpoint, pipeline
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.parallel import sharded
    from fqsqueezer_tpu_torch.params import IdMode, Params
    from fqsqueezer_tpu_torch.streams import ids

    def host(t):
        return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    for dp, tp in ((1, 1), (4, 2)):
        p = Params()
        p.genome_size = 1
        p.adjust_kmer_sizes()
        p.n_lanes, p.max_batch_reads, p.local_log2_cells = 8, 64, 10
        p.smer_log2_buckets = p.bmer_log2_buckets = 12
        p.dna_siv_cap = 8
        p.id_mode, p.max_id_len = IdMode.LOSSLESS, 12
        p.mesh_dp, p.mesh_tp = dp, tp
        cfgs = pipeline.make_configs(p)
        R, L = 16 * dp, 40
        rng = np.random.default_rng(dp)
        codes = rng.integers(0, 4, (R, L))
        qsyms = rng.integers(0, 8, (R, L))
        lengths = np.full((R,), L)
        planes = ids.encode_ids_host(
            [f"SIM.{r} {r}".encode() for r in range(R)],
            ids.mesh_read_lanes(R, dp, 8), cfgs[3].n_fields,
            cfgs[3].max_id_len, [None] * dp)
        got = {}
        for dev in ("cpu", "cuda"):
            state = pipeline.state_create(cfgs[0], cfgs[1], cfgs[3], dev)
            on = lambda a: torch.from_numpy(a).to(dev)
            args = (on(codes), on(codes), on(lengths), on(qsyms),
                    tuple(on(a) for a in planes))
            before = rans.K1_LAUNCHES
            if dp == 1:
                outs = pipeline._encode_batch(*cfgs, state, *args)
            else:
                outs = sharded.sharded_encode(*cfgs, state, *args, R - 11,
                                              dp)
            torch.cuda.synchronize()
            got[dev] = ([host(t) for o in outs[:4] for t in o],
                        checkpoint.state_to_arrays(outs[4]),
                        rans.K1_LAUNCHES - before)
        (c_st, c_new, c_k1), (g_st, g_new, g_k1) = got["cpu"], got["cuda"]
        same = (len(c_st) == len(g_st)
                and all(np.array_equal(a, b) for a, b in zip(c_st, g_st))
                and sorted(c_new) == sorted(g_new)
                and all(c_new[k].dtype == g_new[k].dtype
                        and np.array_equal(c_new[k], g_new[k])
                        for k in c_new))
        if not same or (c_k1, g_k1) != (0, 1):
            raise RuntimeError(f"the single-step encode at dp {dp} x tp "
                               f"{tp} differs on the card from its CPU "
                               f"outputs, or K1 launched {g_k1} times "
                               f"(want 1) for it")
    return 2


def phase_mesh_write():
    """Mesh archives written on the card. (a) The two committed -gs 5
    fixtures through mesh_pipeline.compress_file_mesh: each archive's
    sha256 the committed file's (the reference mesh writer's), K1 launched
    once a group. (b) The CLI's e -dp/-tp at full width (MESH_WRITE_CLI:
    100k reads at 4 x 2 shards of 2048 lanes, 10k pairs at 2 x 1 of 1024),
    then its d: the output equal to the input, byte for byte, K1 launched
    once a group, K2 once a read row of each shard (expanded rows with the
    PE anchors) and K3 once a shard and batch. (c) The single-step
    encoders on the card against their CPU outputs (_encoders_on_card).
    Returns K1's launches in (a) and (b)."""
    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.io import fastq
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    k1 = 0
    for name, kind, n, dp, tp, qm, im, budget in MESH_WRITE_FIXTURES:
        p = _mesh_fixture_params(kind, qm, im)
        arc = os.path.join(WORK, f"{name}.written.fqst")
        data = None
        if kind == "pe":
            paths = _pe_corpus(n)
            data = pipeline.interleave_pe(*(fastq.read_fastq(f)
                                            for f in paths))
        else:
            paths = [_corpus(n)[0]]
        _reset_launches()
        _, dt = timed(lambda: mesh_pipeline.compress_file_mesh(
            p, paths[0], arc, dp=dp, tp=tp, data=data,
            group_mem_bytes=budget))
        launches = rans.K1_LAUNCHES
        k1 += launches
        groups = _n_groups(arc, p.n_lanes)
        sha = _sha256(arc)
        want = _sha256(os.path.join(MESH_DIR, f"{name}.fqst"))
        if sha != want or launches != groups:
            raise RuntimeError(f"mesh_write {name}: sha256 {sha} (the "
                               f"reference's {want}), K1 launched "
                               f"{launches} times for {groups} groups")
        print(f"[mesh_write] {name} ({dp}x{tp} mesh, {p.n_lanes} lanes, "
              f"{n} {'pairs' if kind == 'pe' else 'reads'}, a small "
              f"fixture): compress_file_mesh {dt:.3f} s, sha256 == the "
              f"reference mesh writer's, K1 launches {launches} for "
              f"{groups} groups")

    for n, flags in MESH_WRITE_CLI:
        pe = "-p" in flags
        srcs = list(_pe_corpus(n)) if pe else [_corpus(n)[0]]
        tag = "_".join(flags[flags.index("-dp"):]).replace("-", "")
        arc = os.path.join(WORK, f"mesh_{'pe' if pe else 'se'}_{tag}.fqst")
        outs = [f"{arc}.{k}.fastq" for k in (1, 2)][:len(srcs)]
        out_args = ["-out", outs[0]] + (["-out2", outs[1]] if pe else [])
        _reset_launches()
        rc, c_dt = timed(lambda: cli.main(["e", *ONE_CARD, *flags, "-v",
                                           "0", "-out", arc, *srcs]))
        launches = rans.K1_LAUNCHES
        k1 += launches
        _reset_launches()
        rc2, d_dt = timed(lambda: cli.main(["d", *ONE_CARD, "-v", "0",
                                            *out_args, arc]))
        k3, k2 = _launch_counts()
        p, batches, rows, k3_want, reads = _mesh_rows(arc)
        groups = _n_groups(arc, p.n_lanes)
        if rc != 0 or rc2 != 0 or [_sha256(o) for o in outs] != [
                _sha256(f) for f in srcs]:
            raise RuntimeError(f"mesh_write `{' '.join(flags)}`: e returned "
                               f"{rc}, d {rc2}, or the decode differs from "
                               f"the input")
        _check_scans(arc, f"mesh_write `{' '.join(flags)}`")
        if launches != groups or k2 != rows or k3 != k3_want:
            raise RuntimeError(f"mesh_write `{' '.join(flags)}`: K1 launched "
                               f"{launches} times for {groups} groups, K2 "
                               f"{k2} for {rows} shard rows, K3 {k3} (want "
                               f"{k3_want})")
        print(f"[mesh_write] `e {' '.join(flags)}` ({p.mesh_dp}x{p.mesh_tp} "
              f"mesh, {p.n_lanes} lanes a shard, {reads} reads in {batches} "
              f"batches): compress {c_dt:.3f} s, {reads / c_dt:.1f} reads/s, "
              f"{os.path.getsize(arc)} B; d {d_dt:.3f} s, "
              f"{reads / d_dt:.1f} reads/s; BYTE-EXACT; K1 launches "
              f"{launches} for {groups} group(s), K2 {k2} (dp x shard rows), "
              f"K3 {k3}")
    n = _encoders_on_card()
    print(f"[mesh_write] the single-step encoders (pipeline._encode_batch, "
          f"sharded.sharded_encode at 4 x 2) on the card == their CPU "
          f"outputs, exact, one K1 launch each ({n} calls)")
    return k1


def _mesh_legacy_params(gen, kind, order, qm, im, route):
    """A [mesh_legacy] fixture's Params (tests/test_torch_mesh_legacy.py's
    fixture_params): the CPU geometry of the mesh fixtures (-gs 1 k-mers,
    16 lanes, 128-read batches, 2^12-bucket s/b tables, SIV cap 7), the
    generation's knobs with the k-mer geometry re-tuned, 2^10 local cells
    for H1-H4."""
    from fqsqueezer_tpu_torch.params import (HEADER_GENERATIONS, DnaMode,
                                             IdMode, Params, QualityMode)

    p = Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.dna_mode = {("se", "o"): DnaMode.SE_ORIGINAL,
                  ("se", "s"): DnaMode.SE_SORTED,
                  ("pe", "o"): DnaMode.PE_ORIGINAL}[kind, order]
    p.quality_mode = QualityMode(qm)
    p.id_mode = IdMode(im)
    if gen is not None:
        for k, v in HEADER_GENERATIONS[gen].items():
            setattr(p, k, v)
        p.adjust_kmer_sizes()
    p.n_lanes, p.verbosity, p.max_batch_reads = 16, 0, 128
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.dna_siv_cap = 7
    if gen is None:
        p.local_log2_cells = 16
    elif gen in ("H1", "H2", "H3", "H4"):
        p.local_log2_cells = 10
    p.mesh_route_sb = route
    return p


def _mesh_legacy_inputs(name, kind, corpus):
    """A [mesh_legacy] fixture's input file(s), regenerated from its seed."""
    from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                                   write_pe_corpus,
                                                   write_repeat_corpus)

    n, L, seed = corpus
    if kind == "pe":
        paths = [os.path.join(WORK, f"{name}_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*paths, n, L, 20_000, seed=seed)
        return paths
    path = os.path.join(WORK, f"{name}.fastq")
    if name == "route_drop_dp2tp4":
        write_repeat_corpus(path, n, L, seed=seed, odd=MESH_LEGACY_DROP_ODD)
    else:
        write_fastq_corpus(path, n, L, 20_000, seed=seed)
    return [path]


def _mesh_legacy_sums():
    out = {}
    with open(os.path.join(MESH_LEGACY_DIR, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


def _kernel_ms(fn):
    """fn's result and the device time of each K2 and K3 launch in it:
    every launch bracketed by CUDA events (a sync after each, so run it
    apart from a timed run). Returns (result, K2 ms list, K3 ms list)."""
    import torch

    from fqsqueezer_tpu_torch.streams import dna, quality

    times = {"k2": [], "k3": []}
    orig = dna._dna_decode_row_cuda, quality._qual_decode_scan_cuda

    def wrap(f, key):
        def g(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = f(*a, **kw)
            e1.record()
            e1.synchronize()
            times[key].append(e0.elapsed_time(e1))
            return out
        return g

    dna._dna_decode_row_cuda = wrap(orig[0], "k2")
    quality._qual_decode_scan_cuda = wrap(orig[1], "k3")
    try:
        out = fn()
    finally:
        dna._dna_decode_row_cuda, quality._qual_decode_scan_cuda = orig
    return out, times["k2"], times["k3"]


def phase_mesh_legacy():
    """Mesh archives of every header a JAX mesh writer stores, on the card.
    (a) The committed fixtures (MESH_LEGACY_FIXTURES: H0, H1, H4 and H6 on
    dp x tp meshes, SE, PE and sorted order, and mesh_route_sb at tp 4)
    written through mesh_pipeline.compress_file_mesh from their
    regenerated inputs, each archive's sha256 the committed file's, K1 once
    a group; each decoded through the CLI's d to the reference's digests
    (SHA256SUMS), K2 once a read row of each shard, K3 once a shard and
    batch with a quality stream — route_drop_dp2tp4's decode failing as
    the reference's does. (b) The 100k corpus at full width
    (MESH_LEGACY_FULL: H0 and H4 at dp 4 x tp 2, today's header at
    mesh_route_sb 1 and dp 2 x tp 4) compressed and decoded, timed,
    BYTE-EXACT, with peak CUDA memory, the routed exchange's dropped
    events, and in a second decode every K2 and K3 launch's device time.
    (c) The per-shard copy of the K2 tables that remains: timed for the
    row-global families, none for the batch-frozen ones. Returns K1's
    launches."""
    import torch

    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.io import fastq
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    t0 = time.time()
    sums = _mesh_legacy_sums()
    k1 = 0
    for (name, gen, kind, order, qm, im, corpus, dp, tp, budget,
         route) in MESH_LEGACY_FIXTURES:
        paths = _mesh_legacy_inputs(name, kind, corpus)
        p = _mesh_legacy_params(gen, kind, order, qm, im, route)
        arc = os.path.join(WORK, f"{name}.written.fqst")
        kw = {} if budget is None else {"group_mem_bytes": budget}
        data = None
        if kind == "pe":
            data = pipeline.interleave_pe(*(fastq.read_fastq(f)
                                            for f in paths))
        _reset_launches()
        st, dt = timed(lambda: mesh_pipeline.compress_file_mesh(
            p, paths[0], arc, dp=dp, tp=tp, data=data, **kw))
        launches = rans.K1_LAUNCHES
        k1 += launches
        groups = _n_groups(arc, p.n_lanes)
        sha = _sha256(arc)
        want = _sha256(os.path.join(MESH_LEGACY_DIR, f"{name}.fqst"))
        if sha != want or launches != groups:
            raise RuntimeError(f"mesh_legacy {name}: sha256 {sha} (the "
                               f"reference's {want}), K1 launched "
                               f"{launches} times for {groups} groups")
        outs = [os.path.join(WORK, f"{name}.dec_{k}.fastq")
                for k in (1, 2)][:len(paths)]
        out_args = ["-out", outs[0]] + (["-out2", outs[1]]
                                        if len(outs) == 2 else [])
        _reset_launches()
        try:
            rc = cli.main(["d", *ONE_CARD, "-v", "0", *out_args, arc])
        except SystemExit as e:
            rc = e.code
        k3, k2 = _launch_counts()
        _, batches, rows, k3_want, _ = _mesh_rows(arc)
        if name == "route_drop_dp2tp4":
            if rc != f"error: {MESH_LEGACY_DROP_ERROR}":
                raise RuntimeError(f"mesh_legacy {name}: the CLI's d gave "
                                   f"{rc!r}, not the reference's "
                                   f"{MESH_LEGACY_DROP_ERROR!r}")
            how = f"d fails as the reference's: {MESH_LEGACY_DROP_ERROR}"
        else:
            names = ([f"{name}_1.fastq", f"{name}_2.fastq"] if kind == "pe"
                     else [f"{name}.fastq"])
            got = [_sha256(o) for o in outs]
            if rc != 0 or got != [sums[n] for n in names]:
                raise RuntimeError(f"mesh_legacy {name}: the CLI's d "
                                   f"returned {rc}, sha256 {got} != the "
                                   f"reference's")
            how = "d sha256 == the reference's sequential decode"
            _check_scans(arc, f"mesh_legacy {name}")
        if k2 != rows or k3 != k3_want:
            raise RuntimeError(f"mesh_legacy {name}: K2 launched {k2} times "
                               f"for {rows} shard rows, K3 {k3} (want "
                               f"{k3_want})")
        print(f"[mesh_legacy] {name} ({gen or 'today'}, {dp}x{tp}, "
              f"route_sb {route}): compress_file_mesh {dt:.3f} s, sha256 == "
              f"the reference mesh writer's, {st['route_dropped']} events "
              f"dropped by the route cap, K1 {launches} for {groups} "
              f"groups; {how}; K2 {k2} (dp x shard rows), K3 {k3}")

    for gen, route, flags in MESH_LEGACY_FULL:
        src = _corpus(FULL_READS)[0]
        dp, tp = (int(flags[flags.index(f) + 1]) for f in ("-dp", "-tp"))
        p = cli.parse_args(["e", *flags, "-v", "0", src])
        if gen is not None:
            from fqsqueezer_tpu_torch.params import header_generation

            header_generation(p, gen)
        p.mesh_route_sb = route
        tag = f"mesh_legacy_{gen or 'today'}_r{route}_{dp}x{tp}"
        arc = os.path.join(WORK, f"{tag}.fqst")
        out = os.path.join(WORK, f"{tag}.dec.fastq")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        st, c_dt = timed(lambda: mesh_pipeline.compress_file_mesh(
            p, src, arc, dp=dp, tp=tp))
        peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = rans.K1_LAUNCHES
        k1 += launches
        groups = _n_groups(arc, p.n_lanes)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        rc, d_dt = timed(lambda: cli.main(["d", *ONE_CARD, "-v", "0",
                                           "-out", out, arc]))
        peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
        k3, k2 = _launch_counts()
        _, batches, rows, k3_want, reads = _mesh_rows(arc)
        if rc != 0 or _sha256(out) != _sha256(src):
            raise RuntimeError(f"mesh_legacy `{' '.join(flags)}` under "
                               f"{gen or 'today'}: d returned {rc}, or the "
                               f"decode differs from the input")
        _check_scans(arc, f"mesh_legacy {tag}")
        if launches != groups or k2 != rows or k3 != k3_want:
            raise RuntimeError(f"mesh_legacy {tag}: K1 launched {launches} "
                               f"times for {groups} groups, K2 {k2} for "
                               f"{rows} shard rows, K3 {k3} (want "
                               f"{k3_want})")
        _, k2_ms, k3_ms = _kernel_ms(lambda: cli.main(
            ["d", *ONE_CARD, "-v", "0", "-out", out, arc]))
        print(f"[mesh_legacy] 100k `e {' '.join(flags)}` under "
              f"{gen or 'today'}'s header, mesh_route_sb {route} "
              f"({p.n_lanes} lanes a shard, {reads} reads in {batches} "
              f"batches): compress {reads / c_dt:.1f} reads/s ({c_dt:.3f} s, "
              f"peak {peak_e:.3f} GiB, K1 {launches} for {groups} groups, "
              f"{st['route_dropped']} events dropped by the route cap); d "
              f"{reads / d_dt:.1f} reads/s ({d_dt:.3f} s, peak "
              f"{peak_d:.3f} GiB); BYTE-EXACT; K2 {k2} launches "
              f"({sum(k2_ms):.3f} ms of device time, "
              f"{sum(k2_ms) / max(1, len(k2_ms)):.4f} ms a shard row), K3 "
              f"{k3} ({sum(k3_ms):.3f} ms, "
              f"{sum(k3_ms) / max(1, len(k3_ms)):.4f} ms a shard and "
              f"batch), each launch timed by CUDA events in a second d")

    for gen in ("H0", "H4", "H6", None):
        p = cli.parse_args(["e", "-gs", "5", "-v", "0", "x"])
        if gen is not None:
            from fqsqueezer_tpu_torch.params import header_generation

            header_generation(p, gen)
        dcfg = pipeline.make_configs(p)[0]
        st = pipeline.state_create(dcfg, None, None, "cuda").dna
        if dcfg.row_global:
            ms = _ms(lambda: (st.s_tc.clone(), st.b_tc.clone()), 20)
            what = (f"copied a shard and batch: 2 x "
                    f"{tuple(st.s_tc.shape)} in {ms:.4f} ms")
        else:
            what = "not copied (batch-frozen: K2 reads the state's)"
        print(f"[mesh_legacy] the K2 tables under {gen or 'today'}'s header "
              f"at -gs 5 ({_table_kind(dcfg)}): {what}")
        del st
    torch.cuda.synchronize()
    print(f"[mesh_legacy] the phase took {time.time() - t0:.1f} s")
    return k1


def _make_fastq(path, n_reads, read_len, seed=0, genome_kb=20):
    """tests/test_pipeline.py's make_fastq, copied here (the card has no
    JAX): reads sampled from a small random genome, the SE input of the
    testdata/mesh CPU fixtures."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_kb * 1000)
    lines = []
    for i in range(n_reads):
        hdr = f"@SRR0.{i + 1} {i + 1} length={read_len}"
        start = rng.integers(0, len(genome) - read_len)
        seq = genome[start:start + read_len].copy()
        nerr = rng.poisson(0.5)
        for _ in range(nerr):
            seq[rng.integers(0, read_len)] = rng.integers(0, 4)
        if rng.random() < 0.05:
            seq[rng.integers(0, read_len)] = 4
        s = "".join("ACGTN"[b] for b in seq)
        q = "".join(chr(33 + int(c)) for c in
                    np.clip(rng.normal(35, 4, read_len), 0, 70).astype(int))
        lines += [hdr, s, "+", q]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _make_pe_pair(d, n_pairs, read_len, seed, genome_kb=30):
    """tests/test_pe.py's make_pe_pair, copied here: mates from opposite
    ends of fragments of a random genome, in d/r1.fastq and d/r2.fastq."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_kb * 1000)
    f1, f2 = [], []
    for i in range(n_pairs):
        frag = rng.integers(0, len(genome) - 300)
        r1 = genome[frag:frag + read_len]
        r2 = (3 - genome[frag + 200:frag + 200 + read_len])[::-1]
        q = "I" * read_len
        f1 += [f"@PAIR.{i + 1} {i + 1}/1", "".join("ACGT"[b] for b in r1),
               "+", q]
        f2 += [f"@PAIR.{i + 1} {i + 1}/2", "".join("ACGT"[b] for b in r2),
               "+", q]
    os.makedirs(d, exist_ok=True)
    paths = (os.path.join(d, "r1.fastq"), os.path.join(d, "r2.fastq"))
    for path, lines in zip(paths, (f1, f2)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


def _mesh_cpu_params(kind, order, qm, im):
    """tests/test_torch_mesh.py's mesh_params at "cpu": -gs 1 k-mers, 16
    lanes, 128-read batches, 2^12-bucket s/b tables, SIV cap 7."""
    from fqsqueezer_tpu_torch.params import (DnaMode, IdMode, Params,
                                             QualityMode)

    p = Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.dna_mode = {("se", "o"): DnaMode.SE_ORIGINAL,
                  ("se", "s"): DnaMode.SE_SORTED,
                  ("pe", "o"): DnaMode.PE_ORIGINAL}[kind, order]
    p.quality_mode = QualityMode(qm)
    p.id_mode = IdMode(im)
    p.n_lanes, p.verbosity, p.max_batch_reads = 16, 0, 128
    p.local_log2_cells = 16
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.dna_siv_cap = 7
    return p


def _sums(d):
    out = {}
    with open(os.path.join(d, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


def _mesh_rank_fixtures(d):
    """Every fixture of testdata/mesh and testdata/mesh_legacy as run_ranks
    jobs, their inputs regenerated into directory d: a dict a fixture,
    with its dp, the write job (the archive at "arc"), the decode job of
    the committed archive ("ref") into "outs", the digests those must
    have ("want": the JAX decoders'; route_drop_dp2tp4's the JAX mesh
    decode's), and the kernel instantiations its decode runs, by their
    names in main's kernels line ("k2", "k3"). snap_dp2tp1 writes its
    snapshots, and its entry has the resume from the committed group-1
    snapshot as a second decode job."""
    from fqsqueezer_tpu_torch.params import Params

    os.makedirs(d, exist_ok=True)
    mesh_sums, legacy_sums = _sums(MESH_DIR), _sums(MESH_LEGACY_DIR)
    out = []

    def entry(name, ref_dir, kind, paths, p, dp, tp, want, k2, k3, **kw):
        arc = os.path.join(d, f"{name}.fqst")
        common = dict(p=p, out_path=arc, dp=dp, tp=tp, **kw)
        write = (("compress_pe", dict(common, in1=paths[0], in2=paths[1]))
                 if kind == "pe" else
                 ("compress", dict(common, in_path=paths[0])))
        ref = os.path.join(ref_dir, f"{name}.fqst")
        outs = [os.path.join(d, f"{name}.dec_{k}.fastq")
                for k in (1, 2)][:len(want)]
        decode = ("decompress", dict(zip(("out_path", "out_path2"), outs),
                                     p_cli=Params(), in_path=ref))
        out.append(dict(name=name, dp=dp, write=write, decode=decode,
                        arc=arc, ref=ref, outs=outs, want=want, k2=k2,
                        k3=k3, p=p))
        return out[-1]

    def names(name, kind):
        return ([f"{name}_1.fastq", f"{name}_2.fastq"] if kind == "pe"
                else [f"{name}.fastq"])

    k3_of = {"lossless": 96, "illumina_8": 8, "none": None}
    for name, kind, (n, L, seed), dp, tp, order, qm, im in MESH_CPU_FIXTURES:
        if kind == "pe":
            paths = _make_pe_pair(os.path.join(d, name), n, L, seed)
        else:
            paths = [os.path.join(d, f"{name}.fastq")]
            _make_fastq(paths[0], n, L, seed)
        kw = {}
        if name == "snap_dp2tp1":
            kw = dict(group_mem_bytes=MESH_SNAP_GROUP_MEM,
                      snapshot_prefix=os.path.join(d, name))
        e = entry(name, MESH_DIR, kind, paths,
                  _mesh_cpu_params(kind, order, qm, im), dp, tp,
                  [mesh_sums[x] for x in names(name, kind)],
                  {"pe": "pe", "s": "sorted"}.get(
                      kind if kind == "pe" else order, "main"),
                  k3_of[qm], **kw)
        if name == "snap_dp2tp1":
            out_g1 = os.path.join(d, f"{name}.g1.fastq")
            e["resume"] = ("decompress", dict(
                e["decode"][1], out_path=out_g1, start_group=1,
                snapshot=os.path.join(MESH_DIR, f"{name}.g00001.npz")))
            e["resume_out"] = out_g1
            e["resume_want"] = mesh_sums[f"{name}.g1.fastq"]
    for (name, kind, n, dp, tp, qm, im, budget), (_, want) in zip(
            MESH_WRITE_FIXTURES, MESH_FIXTURES):
        paths = list(_pe_corpus(n)) if kind == "pe" else [_corpus(n)[0]]
        entry(name, MESH_DIR, kind, paths, _mesh_fixture_params(kind, qm, im),
              dp, tp, list(want), "pe" if kind == "pe" else "main",
              k3_of[qm], group_mem_bytes=budget)
    for (name, gen, kind, order, qm, im, corpus, dp, tp, budget,
         route) in MESH_LEGACY_FIXTURES:
        paths = _mesh_legacy_inputs(name, kind, corpus)
        kw = {} if budget is None else {"group_mem_bytes": budget}
        want = ([MESH_RANKS_DROP] if name == "route_drop_dp2tp4" else
                [legacy_sums[x] for x in names(name, kind)])
        k2 = "main" if gen is None else gen + (" sorted" if order == "s"
                                               else "")
        k3 = "H1" if gen == "H1" else k3_of[qm]
        entry(name, MESH_LEGACY_DIR, kind, paths,
              _mesh_legacy_params(gen, kind, order, qm, im, route), dp, tp,
              want, k2, k3, **kw)
    return out


def _gather_job(world):
    """run_ranks' gather job on known arrays, and what it must give: every
    leaf the ranks' leaves concatenated in rank order, the ranks' word
    buffers (of different lengths, one empty) too."""
    import numpy as np

    rng = np.random.default_rng(world)
    trees = [[rng.integers(-2 ** 40, 2 ** 40, (3, 5)),
              rng.random((3, 2)) < 0.5,
              rng.integers(0, 2 ** 31, (2,)).astype(np.int32)]
             for _ in range(world)]
    words = [rng.integers(0, 1 << 16, 5 * r).astype(np.int32)
             for r in range(world)]
    want = {"tree": [np.concatenate([t[i] for t in trees])
                     for i in range(3)],
            "words": np.concatenate(words)}
    return ("gather", dict(trees=trees, words=words)), want


def _run_rank_fixtures(entries, world, backend, device, extra=()):
    """Write and decode `entries` (_mesh_rank_fixtures) on `world` ranks,
    with a gather job first and `extra` jobs last, all in one launch; hold
    every archive to its committed bytes (snap_dp2tp1's snapshot to the
    committed one, array for array), every decode to its digests, K1 to
    one launch a group flush on every rank, K2 to one launch a read row of
    each shard and K3 to one a shard and batch with a quality stream
    (summed over the ranks). Returns (every rank's records of `extra`, the
    launch's wall, K1's launches, K2's and K3's launches by kernel
    instantiation (_mesh_rank_fixtures' k2 and k3 names))."""
    import numpy as np

    from fqsqueezer_tpu_torch.parallel import mesh_pipeline

    gather, g_want = _gather_job(world)
    jobs = [gather]
    for e in entries:
        jobs += [e["write"], e["decode"]] + ([e["resume"]] if "resume" in e
                                             else [])
    jobs += list(extra)
    t0 = time.time()
    recs = mesh_pipeline.run_ranks(jobs, world, backend, device,
                                   timeout=400)
    wall = time.time() - t0
    for rec in recs:
        got = rec[0]["result"]
        if not (all(np.array_equal(a, b) and a.dtype == b.dtype
                    for a, b in zip(got["tree"], g_want["tree"]))
                and np.array_equal(got["words"], g_want["words"])):
            raise RuntimeError(f"mesh_ranks: the {backend} gather of "
                               f"{world} ranks is not the ranks' tensors "
                               f"concatenated in rank order")
    k1, k2, k3 = 0, {}, {}
    at = 1
    tag = f"{backend}, {world} rank(s)"
    for e in entries:
        w_recs = [rec[at] for rec in recs]
        d_recs = [rec[at + 1] for rec in recs]
        at += 2 + ("resume" in e)
        p, batches, rows, k3_want, reads = _mesh_rows(e["ref"])
        groups = _n_groups(e["ref"], p.n_lanes)
        sha = _sha256(e["arc"])
        if sha != _sha256(e["ref"]):
            raise RuntimeError(f"mesh_ranks {e['name']} ({tag}): archive "
                               f"sha256 {sha} != the committed file's")
        got = [_sha256(o) for o in e["outs"]]
        if got != e["want"]:
            raise RuntimeError(f"mesh_ranks {e['name']} ({tag}): decode "
                               f"sha256 {got} != {e['want']}")
        w_k1 = [r["launches"]["K1"] for r in w_recs]
        d_k2 = sum(r["launches"]["K2"] for r in d_recs)
        d_k3 = sum(r["launches"]["K3"] for r in d_recs)
        if w_k1 != [groups] * world or d_k2 != rows or d_k3 != k3_want:
            raise RuntimeError(f"mesh_ranks {e['name']} ({tag}): K1 "
                               f"launched {w_k1} times a rank for {groups} "
                               f"groups, K2 {d_k2} for {rows} shard rows, "
                               f"K3 {d_k3} (want {k3_want})")
        _check_scans(e["ref"], f"mesh_ranks {e['name']} ({tag})",
                     *(sum(r["launches"][k] for r in d_recs)
                       for k in ("K4", "K5")))
        k1 += sum(w_k1)
        k2[e["k2"]] = k2.get(e["k2"], 0) + d_k2
        if e["k3"] is not None:
            k3[e["k3"]] = k3.get(e["k3"], 0) + d_k3
        more = ""
        if "resume" in e:
            snap = os.path.join(MESH_DIR, f"{e['name']}.g00001.npz")
            with np.load(snap) as want, np.load(
                    e["write"][1]["snapshot_prefix"] + ".g00001.npz") as z:
                if sorted(z.files) != sorted(want.files) or not all(
                        z[k].dtype == want[k].dtype
                        and np.array_equal(z[k], want[k])
                        for k in want.files):
                    raise RuntimeError(f"mesh_ranks {e['name']} ({tag}): "
                                       f"the group-1 snapshot differs "
                                       f"from the committed one")
            if _sha256(e["resume_out"]) != e["resume_want"]:
                raise RuntimeError(f"mesh_ranks {e['name']} ({tag}): the "
                                   f"decode from the group-1 snapshot "
                                   f"differs from the JAX decoder's")
            more = ("; group-1 snapshot == the committed one, and the "
                    "decode from it == the JAX decoder's tail")
        print(f"[mesh_ranks] {e['name']} ({tag}, {e['dp']} shards, "
              f"{reads} reads in {batches} batches): archive == the JAX "
              f"mesh writer's, K1 {w_k1} a rank for {groups} groups; decode "
              f"== {'the JAX mesh decode' if e['name'] == 'route_drop_dp2tp4' else 'the JAX decoder'}'s, "
              f"K2 {d_k2} (dp x shard rows), K3 {d_k3}{more}")
    return [rec[at:] for rec in recs], wall, k1, k2, k3


def _card():
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        "nvidia-smi: " + smi.stderr.strip())


def _one_process_mesh(flags, src, arc, out, reps):
    """compress_file_mesh and decompress_file_mesh_seq of src at the mesh
    of `flags` on one process on the card, `reps` times each (the last
    timed): (compress seconds, decode seconds)."""
    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    dp, tp = (int(flags[flags.index(f) + 1]) for f in ("-dp", "-tp"))
    for _ in range(reps):
        p = cli.parse_args(["e", *flags, "-v", "0", src])
        _, c_dt = timed(lambda: mesh_pipeline.compress_file_mesh(
            p, src, arc, dp=dp, tp=tp))
    for _ in range(reps):
        _, d_dt = timed(lambda: mesh_pipeline.decompress_file_mesh_seq(
            Params(), arc, out))
    return c_dt, d_dt


def _full_jobs(flags, src, arc, out, reps):
    """run_ranks' jobs: the mesh compress of src at `flags`, then its
    decode, `reps` times each (the last the timed one)."""
    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.params import Params

    dp, tp = (int(flags[flags.index(f) + 1]) for f in ("-dp", "-tp"))
    return ([("compress", dict(p=cli.parse_args(["e", *flags, "-v", "0",
                                                  src]),
                               in_path=src, out_path=arc, dp=dp, tp=tp))]
            * reps + [("decompress", dict(p_cli=Params(), in_path=arc,
                                          out_path=out))] * reps)


def _rank_walls(recs, k):
    """The slowest rank's wall of job k."""
    return max(rec[k]["seconds"] for rec in recs)


def phase_mesh_ranks():
    """The dp x tp mesh on several processes, one rank each
    (mesh_pipeline.run_ranks): (a) NCCL at world 1 on the card: every
    testdata/mesh and testdata/mesh_legacy fixture written (== the
    committed archive, snap_dp2tp1's snapshot too) and the committed
    archives decoded (== the JAX decoders' digests; route_drop_dp2tp4's
    == the JAX mesh decode's, MESH_RANKS_DROP), K1 once a group flush, K2
    once a shard row, K3 once a shard and batch; (b) gloo ranks sharing
    the one card, R = dp (2 and 4): the same for each fixture of that dp,
    and at R = 2 the 100k corpus at MESH_RANKS_SHARED compressed (== the
    one-process writer's archive of it in this run) and decoded
    (BYTE-EXACT); their walls are no speed figure; (c) where torch sees 2
    cards or more, NCCL across min(cards, 4) of them at MESH_RANKS_CARDS
    on the 100k corpus, compress and decode (warm-up, then timed) beside
    the one-process path's, the archives equal and the decode BYTE-EXACT.
    Returns K1's launches and K2's and K3's by kernel instantiation, every
    rank's summed."""
    import torch

    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline

    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    k1, k2, k3 = 0, {}, {}

    def add(run):
        nonlocal k1
        k1 += run[2]
        for tot, part in ((k2, run[3]), (k3, run[4])):
            for k, n in part.items():
                tot[k] = tot.get(k, 0) + n

    d = os.path.join(WORK, "mesh_ranks")
    entries = _mesh_rank_fixtures(d)
    run = _run_rank_fixtures(entries, 1, "nccl", None)
    add(run)
    print(f"[mesh_ranks] NCCL at world 1 (the card): {len(entries)} "
          f"fixtures written and decoded in one launch of {run[1]:.1f} s")

    src = _corpus(FULL_READS)[0]
    arc_one = os.path.join(WORK, "mesh_ranks_one.fqst")
    arc, out = (os.path.join(WORK, f"mesh_ranks_shared.{x}")
                for x in ("fqst", "fastq"))
    for world in (2, 4):
        mine = [e for e in entries if e["dp"] == world]
        extra = (_full_jobs(MESH_RANKS_SHARED, src, arc, out, 1)
                 if world == 2 else ())
        run = _run_rank_fixtures(mine, world, "gloo", "cuda:0", extra)
        add(run)
        print(f"[mesh_ranks] gloo, {world} ranks sharing the one card: "
              f"{len(mine)} fixtures in one launch of {run[1]:.1f} s (ranks "
              f"sharing one card: not a speed figure)")
        if world != 2:
            continue
        recs = run[0]
        c_one, d_one = _one_process_mesh(MESH_RANKS_SHARED, src, arc_one,
                                         arc_one + ".fastq", 1)
        if _sha256(arc) != _sha256(arc_one):
            raise RuntimeError("mesh_ranks: the 100k archive of 2 ranks "
                               "differs from the one-process writer's")
        if _sha256(out) != _sha256(src):
            raise RuntimeError("mesh_ranks: the 100k decode of 2 ranks "
                               "differs from the input")
        for rec in recs:
            run_k = (rec[0]["launches"], rec[1]["launches"])
            k1 += run_k[0]["K1"]
            k2["main"] = k2.get("main", 0) + run_k[1]["K2"]
            k3[96] = k3.get(96, 0) + run_k[1]["K3"]
        print(f"[mesh_ranks] 100k `e {' '.join(MESH_RANKS_SHARED)}` on 2 "
              f"gloo ranks sharing the one card: archive == the "
              f"one-process writer's, decode BYTE-EXACT; compress "
              f"{_rank_walls(recs, 0):.3f} s, decode "
              f"{_rank_walls(recs, 1):.3f} s (ranks sharing one card: not "
              f"a speed figure; one process on the card: "
              f"{c_one:.3f} s and {d_one:.3f} s)")

    if n_cards >= 2:
        world = 4 if n_cards >= 4 else 2
        arc, out = (os.path.join(WORK, f"mesh_ranks_cards.{x}")
                    for x in ("fqst", "fastq"))
        one_arc, one_out = (os.path.join(WORK, f"mesh_ranks_cards_one.{x}")
                            for x in ("fqst", "fastq"))
        recs = mesh_pipeline.run_ranks(
            _full_jobs(MESH_RANKS_CARDS, src, arc, out, 2), world, "nccl",
            timeout=300)
        c_one, d_one = _one_process_mesh(MESH_RANKS_CARDS, src, one_arc,
                                         one_out, 2)
        if _sha256(arc) != _sha256(one_arc) or _sha256(out) != _sha256(src):
            raise RuntimeError(f"mesh_ranks: NCCL on {world} cards: the "
                               f"archive differs from the one-process "
                               f"writer's, or the decode from the input")
        for rec in recs:
            k1 += sum(r["launches"]["K1"] for r in rec[:2])
            k2["main"] = k2.get("main", 0) + sum(r["launches"]["K2"]
                                                 for r in rec[2:])
            k3[96] = k3.get(96, 0) + sum(r["launches"]["K3"]
                                         for r in rec[2:])
        c_dt, d_dt = _rank_walls(recs, 1), _rank_walls(recs, 3)
        print(f"[mesh_ranks] 100k `e {' '.join(MESH_RANKS_CARDS)}` over "
              f"NCCL on {world} cards ({_card()} each): compress "
              f"{FULL_READS / c_dt:.1f} reads/s ({c_dt:.3f} s), decode "
              f"{FULL_READS / d_dt:.1f} reads/s ({d_dt:.3f} s); one "
              f"process on one card: compress {FULL_READS / c_one:.1f} "
              f"reads/s ({c_one:.3f} s), decode {FULL_READS / d_one:.1f} "
              f"reads/s ({d_one:.3f} s); archives equal, decode BYTE-EXACT "
              f"(the slowest rank's wall of the second run, spawn "
              f"excluded)")
    else:
        print(f"[mesh_ranks] torch sees {n_cards} card: NCCL ran at world 1 "
              f"and the multi-rank runs were gloo ranks sharing the card; "
              f"NCCL across cards needs a machine with 2 or more")
    print(f"[mesh_ranks] the phase took {time.time() - t0:.1f} s")
    return k1, k2, k3


def _table_kind(dcfg):
    """The s/b table family of dcfg and its update mode, in words."""
    from fqsqueezer_tpu_torch.streams import dna

    return dna.table_family(dcfg)[0] + (" row-global" if dcfg.row_global
                                        else " batch-frozen")


def phase_verify():
    """The Tier-1 verify recipe through the port's CLI on the card."""
    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.utils.corpus import write_fastq_corpus

    flags, want = VERIFY
    src = os.path.join(WORK, "vfy.fastq")
    arc, out = os.path.join(WORK, "vfy.fqst"), os.path.join(WORK,
                                                           "vfy_rt.fastq")
    write_fastq_corpus(src, 3000, 80, 100_000, seed=9)
    rc = cli.main(["e", *flags, "-v", "0", "-out", arc, src])
    sha = _sha256(arc)
    if rc != 0 or sha != want:
        raise RuntimeError(f"verify: the CLI's e returned {rc}, archive "
                           f"sha256 {sha} != reference {want}")
    _reset_launches()
    rc = cli.main(["d", "-v", "0", "-out", out, arc])
    with open(src, "rb") as f, open(out, "rb") as g:
        same = f.read() == g.read()
    if rc != 0 or not same:
        raise RuntimeError(f"verify: the CLI's d returned {rc}; decode "
                           f"equals the input: {same}")
    k4, k5 = _check_scans(arc, "verify")
    print(f"[verify] 3000 reads `{' '.join(flags)}` through the CLI: "
          f"archive sha256 == reference, decode BYTE-EXACT; K4 launches "
          f"{k4}, K5 {k5}")


def _legacy_params(gen, flags, files):
    """The Params of an older writer's header (params.header_generation)
    for `e` with these flags and input files."""
    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.params import header_generation

    return header_generation(cli.parse_args(["e", *flags, "-v", "0",
                                             *files]), gen)


def _legacy_paths(gen, n, flags):
    """(input files, archive, decoded FASTQs) of a LEGACY row."""
    tag = f"legacy_{gen}_{n}_{''.join(flags).replace('-', '')}"
    files = list(_pe_corpus(n)) if "-p" in flags else [_corpus(n)[0]]
    outs = [os.path.join(WORK, f"{tag}.dec_{k}.fastq")
            for k in range(1, len(files) + 1)]
    return files, os.path.join(WORK, f"{tag}.fqst"), outs


def _legacy_name(gen, flags):
    """A LEGACY row's name: the generation, its order and PE."""
    return (gen + (" sorted" if flags[flags.index("-om") + 1] == "s" else "")
            + (" pe" if "-p" in flags else ""))


def _local_state_zeroing(p):
    """(ms, bytes) of one batch's zeroed in-batch local state on the card
    (the s and b local tables, the DNA and quality deltas where the header
    keeps them), as compress and decode allocate it once a batch; None
    without local statistics."""
    import torch

    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.streams import dna, quality

    dcfg, qcfg = pipeline.make_configs(p)[:2]
    if not dna._with_local(dcfg):
        return None

    def make():
        loc = dna._local_state_create(dcfg, "cuda")
        if qcfg.with_local:
            loc += (quality.local_state_create(qcfg, "cuda"),)
        return loc

    make()
    ms = _ms(make, 5)
    return ms, sum(t.nbytes for t in make())


def _legacy_round_trip(gen, n, flags, want):
    """Compress one legacy row through pipeline.compress_file (or
    compress_pe) on the card, hold the archive to the JAX writer's sha256,
    decode it through the CLI's d; returns (compress s, decode s, K1
    launches, group flushes, K2 launches, read rows, decoded FASTQs, peak
    CUDA memory of the compress and of the decode in GiB); the launches
    are a (K2, K3) pair."""
    import torch

    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed

    files, arc, outs = _legacy_paths(gen, n, flags)
    p = _legacy_params(gen, flags, files)
    write = pipeline.compress_pe if "-p" in flags else pipeline.compress_file
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, dt = timed(lambda: write(p, *files, arc))
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    k1 = rans.K1_LAUNCHES
    groups = _n_groups(arc, p.n_lanes)
    sha = _sha256(arc)
    if sha != want or k1 < max(1, groups):
        raise RuntimeError(f"legacy {gen} `{' '.join(flags)}`: archive "
                           f"sha256 {sha} != the JAX writer's {want}, or K1 "
                           f"launched {k1} times in {groups} flushes")
    _reset_launches()
    out_args = ["-out", outs[0]] + (["-out2", outs[1]] if len(outs) > 1
                                    else [])
    torch.cuda.reset_peak_memory_stats()
    rc, ddt = timed(lambda: cli.main(["d", "-v", "0", *out_args, arc]))
    peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
    if rc != 0:
        raise RuntimeError(f"legacy {gen}: the CLI's d returned {rc}")
    k3, k2 = _check_decode_launches(arc, p.quality_mode.value != "none",
                                    f"legacy {gen} `{' '.join(flags)}`")
    return (dt, ddt, k1, groups, (k2, k3), _batches_and_rows(arc)[1], outs,
            peak_e, peak_d)


def _same_bytes(got, want, what):
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"{what}: the decode differs from the "
                                   f"input")


def phase_legacy():
    """Archives of the JAX package's older writers (LEGACY, LEGACY_FULL):
    each written on the card byte for byte as the JAX writer wrote it,
    decoded through the CLI's d (no --device: the card) to the input
    (BYTE-EXACT) or the JAX decoder's FASTQ, K2 launched once a read row
    (an expanded row with the PE anchors), K1 at least once a group
    flush. The 100k rows are timed both ways, with their peak CUDA memory
    and, for the headers with local statistics, the time and size of one
    batch's zeroed local state. Returns the K2 and the K3 launches of each
    row's decode by its name (_legacy_name; a 100k row's under its
    generation's)."""
    launches, k3_launches = {}, {}
    for gen, n, flags, want, want_dec in LEGACY:
        dt, ddt, k1, groups, (k2, k3), rows, outs, _, _ = \
            _legacy_round_trip(gen, n, flags, want)
        files = _legacy_paths(gen, n, flags)[0]
        if want_dec is None:
            _same_bytes(outs, files, f"legacy {gen} `{' '.join(flags)}`")
            how = "BYTE-EXACT"
        elif _sha256(outs[0]) != want_dec:
            raise RuntimeError(f"legacy {gen} `{' '.join(flags)}`: decode "
                               f"sha256 {_sha256(outs[0])} != the JAX "
                               f"decoder's {want_dec}")
        else:
            how = "sha256 == the JAX decoder's"
        launches[_legacy_name(gen, flags)] = k2
        k3_launches[_legacy_name(gen, flags)] = k3
        print(f"[legacy] {gen} {n} {'pairs' if '-p' in flags else 'reads'} "
              f"`{' '.join(flags)}`: archive sha256 == the JAX writer's, "
              f"decode {how}; e {dt:.2f} s (K1 {k1} in {groups} flushes), "
              f"d {ddt:.2f} s (K2 {k2} for {rows} rows)")
    for gen, n, flags, want in LEGACY_FULL:
        files = _legacy_paths(gen, n, flags)[0]
        dt, ddt, k1, groups, (k2, k3), rows, outs, peak_e, peak_d = \
            _legacy_round_trip(gen, n, flags, want)
        _same_bytes(outs, files, f"legacy {gen} {n}")
        launches[gen] = k2
        k3_launches[gen] = k3
        p = _legacy_params(gen, flags, files)
        zero = _local_state_zeroing(p)
        local = ("" if zero is None else
                 f"; one batch's local state {zero[1] / 2 ** 20:.1f} MiB, "
                 f"zeroed in {zero[0]:.4f} ms")
        print(f"[legacy] {gen} {n} reads `{' '.join(flags)}` "
              f"({p.n_lanes} lanes): "
              f"archive sha256 == the JAX writer's, decode BYTE-EXACT; "
              f"compress {n / dt:.1f} reads/s ({dt:.3f} s, K1 {k1} in "
              f"{groups} flushes, peak {peak_e:.3f} GiB), decode "
              f"{n / ddt:.1f} reads/s ({ddt:.3f} s, K2 {k2} for {rows} read "
              f"rows, peak {peak_d:.3f} GiB){local}")
    return launches, k3_launches


def _k3_check(cfg, model, lengths, words, init, L, what):
    """K3 == the plain scan on the card, exactly; returns K3's outputs."""
    import torch

    from fqsqueezer_tpu_torch.streams import quality

    got = quality.qual_decode_scan(cfg, model, lengths, words, init, L)
    want = quality.qual_decode_scan_plain(cfg, model, lengths, words, init,
                                          L)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("symbols", "final states", "ptr")):
        if g.dtype != w.dtype or not torch.equal(g, w):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            raise RuntimeError(f"K3 disagrees with the plain scan on "
                               f"{what}: {name}, max abs err {err}")
    return got


def _k3_bound_ms(cfg, model, lengths, syms, words_used, L):
    """(ms, 'bytes' | 'operations'): the least time the card could take for
    one batch's scan — the model rows it reads (each distinct row once,
    4 * n_sym bytes), lengths, the consumed words and the states in, u8
    symbols, states and the pointer out; operations for each active
    position: n_sym adds, 2 * (ceil(log2(n_sym)) + 1) for the search and
    K3_OPS_PER_POS."""
    import torch

    from fqsqueezer_tpu_torch.streams import quality

    R = lengths.shape[0]
    pos = torch.arange(L, device=syms.device)[None, :]
    active = pos < lengths[:, None].to(torch.int64)
    ctx = quality.qual_ctx_plane(cfg, syms.to(torch.int64))[active]
    rows = int(torch.unique(ctx).numel())
    N = cfg.n_lanes
    nbytes = (rows * cfg.n_sym * 4 + R * 4 + words_used * 4 + N * 8
              + R * L + N * 8 + 8)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    search = 2 * ((cfg.n_sym - 1).bit_length() + 1)
    ops = int(active.sum()) * (cfg.n_sym + search + K3_OPS_PER_POS)
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _k3_one(n_sym, mode, arc_name, deltas=False):
    """K3 for one symbol count (with in-batch deltas: its delta
    instantiation): exact on random batches and on a real archive's batch
    (arc_name: under WORK, or a path); then its numbers on that batch."""
    import torch

    from fqsqueezer_tpu_torch.streams import quality
    from fqsqueezer_tpu_torch.tools.k3_compare import (CHAIN_LANES,
                                                       chain_batch,
                                                       real_quality_batch)
    from fqsqueezer_tpu_torch.utils.rans_grids import quality_batch

    shapes = K3_MODE_SHAPES + (K3_SHAPES if n_sym == 8 and not deltas
                               else ())
    for N, r_pl, L in shapes:
        cfg = quality.QualConfig(mode=mode, n_lanes=N, with_local=deltas)
        arrs = quality_batch(N * 7 + L + r_pl + n_sym, N, r_pl, L,
                             cfg.n_ctx, cfg.n_sym, N * r_pl * L // 2)
        _k3_check(cfg, *(torch.from_numpy(a).cuda() for a in arrs), L,
                  f"{n_sym} symbols, N={N} r_pl={r_pl} L={L}")
    cfg, model, lengths, words, init, L = real_quality_batch(
        os.path.join(WORK, arc_name))
    if cfg.n_sym != n_sym or cfg.with_local != deltas:
        raise RuntimeError(f"{arc_name} holds {cfg.n_sym}-symbol qualities "
                           f"(deltas: {cfg.with_local})")
    syms, _, ptr = _k3_check(cfg, model, lengths, words, init, L,
                             f"the {mode} archive's batch")
    args = (cfg, model, lengths, words, init, L)
    ms = _ms(lambda: quality.qual_decode_scan(*args), 20)
    chain = chain_batch(args)
    floor_ms = _ms(lambda: quality.qual_decode_scan(*chain), 20)
    plain_ms = _ms(lambda: quality.qual_decode_scan_plain(*args), 2)
    bound_ms, bound_by = _k3_bound_ms(cfg, model, lengths, syms, int(ptr),
                                      L)
    R = lengths.shape[0]
    print(f"[k3] {n_sym} symbols ({mode}{', in-batch deltas' * deltas}): "
          f"exact on {len(shapes)} random shapes and the real batch "
          f"({os.path.basename(arc_name)}: N={cfg.n_lanes}, "
          f"r_pl={R // cfg.n_lanes}, L={L}, {int(ptr)} words): K3 "
          f"{ms:.4f} ms ({ms / (R // cfg.n_lanes * L) * 1e3:.2f} us a "
          f"step), chain floor ({CHAIN_LANES} lanes) {floor_ms:.4f} ms, "
          f"plain torch {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "chain_floor_ms": floor_ms}


def _k3_sorted():
    """K3 on sorted order's real batch: the 20k CLI-default archive's
    second batch (1024 lanes, 4 read rows), exact against the plain scan,
    and its time beside the chain floor."""
    from fqsqueezer_tpu_torch.streams import quality
    from fqsqueezer_tpu_torch.tools.k3_compare import (chain_batch,
                                                       real_quality_batch)

    args = real_quality_batch(os.path.join(
        WORK, f"sorted_cli_{DIGEST_READS}.fqst"))
    cfg, _, lengths, _, _, L = args
    _k3_check(*args, "the sorted archive's batch")
    ms = _ms(lambda: quality.qual_decode_scan(*args), 20)
    chain = chain_batch(args)
    floor_ms = _ms(lambda: quality.qual_decode_scan(*chain), 20)
    r_pl = lengths.shape[0] // cfg.n_lanes
    print(f"[k3] 8 symbols, sorted order's batch (N={cfg.n_lanes}, "
          f"r_pl={r_pl}, L={L}): exact; K3 {ms:.4f} ms "
          f"({ms / (r_pl * L) * 1e3:.2f} us a step), chain floor "
          f"{floor_ms:.4f} ms")


def phase_k3():
    """K3 == its plain version, exact, for every symbol count, on random
    shapes and on real batches (sorted order's too), and its delta
    instantiations (8 and 96 symbols) on random batches and [legacy]'s H1
    archives; returns the numbers of the kernels line, by symbol count (a
    delta instantiation's as "8 deltas", "96 deltas")."""
    out = {n_sym: _k3_one(n_sym, mode, arc) for n_sym, mode, arc in
           K3_MODES}
    _k3_sorted()
    for k, (n_sym, mode) in ((5, (96, "lossless")), (6, (8, "illumina_8"))):
        gen, n, flags, _, _ = LEGACY[k]
        out[f"{n_sym} deltas"] = _k3_one(
            n_sym, mode, _legacy_paths(gen, n, flags)[1], deltas=True)
    _k3_deltas_random()
    return out


def _scan_batch(arc, which):
    """(meta scan args, id scan args or None) of an archive's batch number
    `which` in archive order, or of its last batch (which = -1), with the
    models and lane states the batches before left
    (k4_compare.scan_batches)."""
    from fqsqueezer_tpu_torch.tools.k4_compare import scan_batches

    got = None
    batches = scan_batches(arc)
    for k, b in enumerate(batches):
        got = b
        if k == which:
            break
    batches.close()
    return got


def _scan_record(rec):
    """A kernels-line entry's numbers from k4_compare.measure's record."""
    return {"max_abs_err": 0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "chain_floor_ms": rec["chain_ms"],
            "call_ms": rec["call_ms"]}


def phase_k4():
    """K4 (the id decode scan) == its plain version on the card, exactly
    (the grid, final states and words consumed), on K4's batches: the
    second batch of the 100k -qm o -im o archive (2048 lanes) and of the
    100k -qm n -im o one (1024 lanes), the second batch of [legacy]'s 20k
    H0 archive (id codec v1), the last batch of the 100k -qm o -im o
    archive (padding rows: n_valid < R) and an encoded random batch (F =
    12, M = 300, zero rows, padding); each timed with its plain version,
    chain floor and bound. Returns the first batch's numbers."""
    from fqsqueezer_tpu_torch.streams import ids
    from fqsqueezer_tpu_torch.tools import k4_compare as k4
    from fqsqueezer_tpu_torch.utils.id_batches import id_scan_inputs

    gen, n, flags, _, _ = LEGACY[0]
    qmo = os.path.join(WORK, f"qmo_imo_{FULL_READS}.fqst")
    cases = [
        ("the 100k -qm o -im o archive's second batch", qmo, 1),
        ("the 100k -qm n -im o archive's second batch",
         os.path.join(WORK, f"qmn_imo_{FULL_READS}.fqst"), 1),
        ("the 20k H0 archive's second batch (id codec v1)",
         _legacy_paths(gen, n, flags)[1], 1),
        ("the 100k -qm o -im o archive's last batch (padding rows)", qmo,
         -1)]
    out = None
    for what, arc, which in cases:
        args = k4.id_args_of(_scan_batch(arc, which)[1])
        cfg, _, R, _, _, n_valid = args
        if ("v1" in what) != (cfg.codec_v == 1) or (
                "padding" in what and not n_valid < R):
            raise RuntimeError(f"[k4] {what}: id codec v{cfg.codec_v}, "
                               f"n_valid {n_valid} of {R} reads")
        rec = k4.measure(f"[k4] K4 on {what}, exact", ids.id_decode_scan,
                         ids.id_decode_scan_plain, k4.k4_bound_ms, args)
        out = out or rec
    args = id_scan_inputs(19, 2048, 2, 12, 300, n_pad=300, device="cuda")
    k4.measure("[k4] K4 on a random batch (F = 12, M = 300, zero rows, "
               "300 padding rows), exact", ids.id_decode_scan,
               ids.id_decode_scan_plain, k4.k4_bound_ms, args)
    return _scan_record(out)


def phase_k5():
    """K5 (the meta decode scan) == its plain version on the card, exactly,
    on the second batch of the primary row's 100k archive (2 slots, 2048
    lanes), of the sorted row's (3 slots with the LCP, 1024 lanes) and of
    the PE row's (1024 lanes); each timed with its plain version, chain
    floor and bound. Returns the primary batch's numbers."""
    from fqsqueezer_tpu_torch.streams import meta
    from fqsqueezer_tpu_torch.tools import k4_compare as k4

    out = None
    for what, arc, W in (
            ("the primary row's", _corpus(FULL_READS)[1], 2),
            ("the sorted row's", os.path.join(WORK,
                                              f"sorted_{FULL_READS}.fqst"),
             3),
            ("the PE row's", os.path.join(WORK, f"pe_{PE_100K[0]}.fqst"),
             2)):
        args = _scan_batch(arc, 1)[0]
        if args[0].n_per_read != W:
            raise RuntimeError(f"[k5] {what} batch has "
                               f"{args[0].n_per_read} slots a read")
        rec = k4.measure(f"[k5] K5 on {what} second batch, exact",
                         meta.meta_decode_scan, meta.meta_decode_scan_plain,
                         k4.k5_bound_ms, args)
        out = out or rec
    return _scan_record(out)


def _k3_deltas_random():
    """K3's delta instantiations at 2 and 4 symbols (no [legacy] archive
    holds them) == the plain scan on random batches."""
    import torch

    from fqsqueezer_tpu_torch.streams import quality
    from fqsqueezer_tpu_torch.utils.rans_grids import quality_batch

    for n_sym, mode in ((2, "binary"), (4, "illumina_4")):
        for N, r_pl, L in K3_MODE_SHAPES:
            cfg = quality.QualConfig(mode=mode, n_lanes=N, with_local=True)
            arrs = quality_batch(N * 5 + L + r_pl + n_sym, N, r_pl, L,
                                 cfg.n_ctx, cfg.n_sym, N * r_pl * L // 2)
            _k3_check(cfg, *(torch.from_numpy(a).cuda() for a in arrs), L,
                      f"{n_sym} symbols with deltas, N={N} r_pl={r_pl} "
                      f"L={L}")
    print(f"[k3] 2 and 4 symbols with in-batch deltas: exact on "
          f"{len(K3_MODE_SHAPES)} random shapes each")


def phase_k2():
    """K2 == its plain row step (the scan and the row's table update),
    exact, on every shape, on adversarial tables and on the main path's
    real batch; returns the numbers of the kernels line."""
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.tools import k2_compare as k2c
    from fqsqueezer_tpu_torch.utils.dna_batches import (dna_decode_inputs,
                                                         pe_row_inputs)

    for seed, (N, r_pl, L, grow, short) in enumerate(K2_SHAPES):
        batch = dna_decode_inputs(seed, N, r_pl, L, "cuda", grow, short)
        k2c.check_rows(*batch, L, what=f"N={N} r_pl={r_pl} L={L} "
                                       f"grown={grow} short={short}")
    N, r_pl, L = K2_ADVERSARIAL
    k2c.check_rows(*dna_decode_inputs(11, N, r_pl, L, "cuda",
                                      adversarial=True), L,
                   what="the adversarial tables")
    for seed, (N, r_pl, L) in enumerate(K2_LCP_SHAPES):
        *batch, lcp = dna_decode_inputs(20 + seed, N, r_pl, L, "cuda",
                                        sorted_reads=True)
        k2c.check_rows(*batch, L, lcp,
                       what=f"sorted N={N} r_pl={r_pl} L={L}")
    anchored = 0
    for seed, (N, r_pl, L) in enumerate(K2_PE_SHAPES):
        cfg, st, specs, words, init, _ = pe_row_inputs(30 + seed, N, r_pl,
                                                       L, "cuda")
        k2c.check_spec_rows(cfg, st, specs, words, init, L,
                            what=f"PE N={N} pairs a lane {r_pl} L={L}")
        anchored += sum(int((lcp > 0).sum()) for _, lcp, _, _ in specs
                        if lcp is not None)
    k2c.check_rows(*k2c.real_dna_batch(os.path.join(
        WORK, f"pe_cli_{PE_CLI[0]}.fqst")), what="the PE CLI batch")
    out = {}
    for key, arc in (("main", _corpus(DIGEST_READS)[1]),
                     ("sorted", os.path.join(
                         WORK, f"sorted_cli_{DIGEST_READS}.fqst")),
                     ("pe", os.path.join(WORK, f"pe_{PE_100K[0]}.fqst"))):
        batch = k2c.real_dna_batch(arc)
        rows = k2c.check_rows(*batch, what=f"the {key} path's batch")
        args = [a for a, _ in rows]
        ms = k2c.replay_ms(args, reps=20)
        floor_ms = k2c.replay_ms(k2c.chain_rows(rows), reps=20)
        plain_ms = _ms(lambda: [dna.dna_decode_row_plain(*a[:10])
                                for a in args], 2)
        bound_ms, bound_by = k2c.k2_bound_ms(rows)
        cfg, L, lcp = batch[0], batch[5], batch[6]
        steps = len(rows) * L
        copied = ("" if lcp is None else
                  f", {int(lcp.sum())} of {int(batch[2].sum())} bases "
                  f"copied")
        if key == "pe":
            n_anch = sum(int((a[8] > 0).sum()) for a, _ in rows
                         if a[8] is not None)
            copied = f", {n_anch} anchored lane-rows"
        print(f"[k2] the {key} path's batch (N={cfg.n_lanes}, {len(rows)} "
              f"rows, L={L}{copied}): K2 {ms:.4f} ms a batch "
              f"({ms / steps * 1e3:.2f} us a step), chain floor "
              f"({k2c.CHAIN_LANES} lanes) {floor_ms:.4f} ms, plain torch "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}")
        out[key] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, "chain_floor_ms": floor_ms}
        if key == "pe":
            pe_ms, calls = k2c.pe_row_end_ms(batch)
            print(f"[k2] the PE batch's row-end PE steps (torch ops between "
                  f"K2's launches): {pe_ms:.4f} ms a batch ({calls} calls) "
                  f"against K2's {ms:.4f} ms")
    print(f"[k2] exact on {len(K2_SHAPES)} random batches, the adversarial "
          f"tables, {len(K2_LCP_SHAPES)} sorted batches, "
          f"{len(K2_PE_SHAPES)} PE batches ({anchored} anchored lane-rows) "
          f"and the four real batches, tables included")
    return out


def _k2_timed(key, batch, rows, plain_reps=2):
    """K2, its chain floor, its plain version (k2_compare.plain_row:
    without the table update K2 does not apply itself, as K2's time and
    bound) timed plain_reps times, and the bound on one real batch's
    checked rows; prints them and returns the kernels line's numbers."""
    from fqsqueezer_tpu_torch.tools import k2_compare as k2c

    args = [a for a, _ in rows]
    ms = k2c.replay_ms(args, reps=20)
    floor_ms = k2c.replay_ms(k2c.chain_rows(rows), reps=20)
    plain_ms = _ms(lambda: [k2c.plain_row(a) for a in args], plain_reps)
    bound_ms, bound_by = k2c.k2_bound_ms(rows)
    cfg, L = batch[0], batch[5]
    steps = len(rows) * L
    print(f"[k2] {key} (N={cfg.n_lanes}, {len(rows)} rows, L={L}): K2 "
          f"{ms:.4f} ms a batch ({ms / steps * 1e3:.2f} us a step), chain "
          f"floor ({k2c.CHAIN_LANES} lanes) {floor_ms:.4f} ms, plain torch "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "chain_floor_ms": floor_ms}


def phase_k2_legacy():
    """The K2 instantiations of the older headers (K2_LEGACY) == the plain
    row step on encoded random batches and on the real batches of the
    [legacy] archives; times the table family's (H0, original and sorted
    order) and the ktable family's (H5, H6) real batches. Returns the
    kernels line's numbers of those four."""
    import dataclasses

    from fqsqueezer_tpu_torch.tools import k2_compare as k2c
    from fqsqueezer_tpu_torch.utils import dna_batches as db

    n_checks = 0
    for name, gen, frozen, knobs in K2_LEGACY:
        for seed, (N, r_pl, L, grow, short) in enumerate(K2_LEGACY_SHAPES):
            cfg = (db.legacy_dna_config(gen, N) if gen
                   else db.bench_dna_config(N))
            cfg = dataclasses.replace(
                cfg, smer_log2_buckets=db.LOG2_BUCKETS,
                bmer_log2_buckets=db.LOG2_BUCKETS, **knobs)
            if frozen:
                cfg = dataclasses.replace(cfg, row_global=False, rough=0)
            rows = k2c.check_rows(*db.dna_decode_inputs(
                40 + seed, N, r_pl, L, "cuda", grow, short, cfg=cfg), L,
                what=f"{name} N={N} r_pl={r_pl} L={L} grown={grow} "
                     f"short={short}")
            n_checks += 1
            if (N, r_pl, L, grow, short) == K2_LEGACY_TIMED_SHAPE:
                # the kinds no archive's batch times: K2 on the random
                # batch, its chain floor and its bound
                ms = k2c.replay_ms([a for a, _ in rows], reps=20)
                floor_ms = k2c.replay_ms(k2c.chain_rows(rows), reps=20)
                bound_ms, bound_by = k2c.k2_bound_ms(rows)
                print(f"[k2] {name}, a random batch (N={N}, {r_pl} rows, "
                      f"L={L}): K2 {ms:.4f} ms a batch, chain floor "
                      f"({k2c.CHAIN_LANES} lanes) {floor_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms by {bound_by}")
        N, r_pl, L = K2_LEGACY_SORTED
        cfg = dataclasses.replace(cfg, n_lanes=N)
        *batch, lcp = db.dna_decode_inputs(50, N, r_pl, L, "cuda",
                                           sorted_reads=True, cfg=cfg)
        k2c.check_rows(*batch, L, lcp, what=f"{name}, sorted N={N}")
        n_checks += 1
    out = {}
    for k, (gen, n, flags, _, _) in enumerate(LEGACY):
        batch = k2c.real_dna_batch(_legacy_paths(gen, n, flags)[1])
        rows = k2c.check_rows(*batch, what=f"the legacy {gen} "
                                           f"`{' '.join(flags)}` batch")
        n_checks += 1
        if k in LEGACY_TIMED:
            key = LEGACY_TIMED[k]
            out[key] = _k2_timed(f"the legacy {key} batch", batch, rows)
    print(f"[k2] the older headers' instantiations exact on {n_checks} "
          f"batches ({len(K2_LEGACY)} kinds x random, sorted; the "
          f"{len(LEGACY)} [legacy] archives' real batches), tables "
          f"included")
    return out


def _knob_sums():
    """testdata/knobs/SHA256SUMS: output file name -> the JAX decoder's
    sha256."""
    out = {}
    with open(os.path.join(KNOBS_DIR, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


def _knob_fixture(name, flags, knobs, corpus, mesh):
    """Write one KNOB_FIXTURES archive on the card from its regenerated
    input (tests/test_torch_knobs.py's knob_params: `e FLAGS -gs 1`, the
    knobs and ctx v1, 8 lanes, batches of 16 reads (PE: 32), 2^10-bucket
    tables, SIV cap 7; the mesh one 16 lanes, 64-read batches,
    2^12-bucket tables) and decode it through the CLI's d; returns
    (archive, outputs, K1 launches, K2 launches of the decode, its
    K2_POS_LAUNCHES)."""
    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                                   write_pe_corpus)

    n, L, seed, genome = corpus
    d = os.path.join(WORK, "knobs")
    os.makedirs(d, exist_ok=True)
    if "-p" in flags:
        files = [os.path.join(d, f"{name}_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*files, n, L, genome, seed=seed)
    else:
        files = [os.path.join(d, f"{name}.fastq")]
        write_fastq_corpus(files[0], n, L, genome, seed=seed)
    p = cli.parse_args(["e", *flags, "-gs", "1", *files])
    for k, v in {**knobs, "dna_ctx_v": 1}.items():
        setattr(p, k, v)
    p.adjust_kmer_sizes()
    p.n_lanes, p.max_batch_reads, log2b = (
        (16, 64, 12) if mesh else (8, 32, 10) if "-p" in flags
        else (8, 16, 10))
    p.smer_log2_buckets = p.bmer_log2_buckets = log2b
    p.dna_siv_cap = 7
    p.verbosity = 0
    arc = os.path.join(d, f"{name}.fqst")
    _reset_launches()
    if mesh is not None:
        mesh_pipeline.compress_file_mesh(p, files[0], arc, dp=mesh[0],
                                         tp=mesh[1])
    elif len(files) == 2:
        pipeline.compress_pe(p, *files, arc)
    else:
        pipeline.compress_file(p, files[0], arc)
    k1 = rans.K1_LAUNCHES
    outs = [os.path.join(d, f"{name}.dec_{k}.fastq")
            for k in range(1, len(files) + 1)]
    _reset_launches()
    rc = cli.main(["d", *(ONE_CARD if mesh else ()), "-v", "0", "-out",
                   outs[0], *(["-out2", outs[1]] if len(outs) > 1 else []),
                   arc])
    if rc != 0:
        raise RuntimeError(f"[knobs] {name}: the CLI's d returned {rc}")
    return arc, outs, k1, dna.K2_LAUNCHES, dict(dna.K2_POS_LAUNCHES)


def _knob_full(name, knobs, n, flags):
    """One KNOBS_FULL row on the card: compress through pipeline
    (compress_file, or compress_pe), decode through
    pipeline.decompress_file, each timed with its peak CUDA memory;
    returns (archive, outputs, compress (stats, s, GiB), K1 launches,
    decode (s, GiB), K2 launches, K2_POS_LAUNCHES, K3 launches, lanes)."""
    from fqsqueezer_tpu_torch import cli, pipeline
    from fqsqueezer_tpu_torch.ops import rans
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.streams import dna, quality
    from fqsqueezer_tpu_torch.tools.bench_gpu import timed_peak

    files = list(_pe_corpus(n)) if "-p" in flags else [_corpus(n)[0]]
    p = cli.parse_args(["e", *flags, *files])
    for k, v in knobs.items():
        setattr(p, k, v)
    p.verbosity = 0
    arc = os.path.join(WORK, f"knobs_{name}_{n}.fqst")
    outs = [os.path.join(WORK, f"knobs_{name}_{n}.dec_{k}.fastq")
            for k in range(1, len(files) + 1)]
    write = pipeline.compress_pe if len(files) == 2 else \
        pipeline.compress_file
    _reset_launches()
    stats, dt, peak = timed_peak(lambda: write(p, *files, arc))
    k1 = rans.K1_LAUNCHES
    _reset_launches()
    _, ddt, dpeak = timed_peak(lambda: pipeline.decompress_file(
        Params(), arc, *outs))
    return (arc, outs, (stats, dt, peak), k1, (ddt, dpeak), dna.K2_LAUNCHES,
            dict(dna.K2_POS_LAUNCHES), quality.K3_LAUNCHES, p.n_lanes)


def _want_pos_launches(knobs, pe, rows):
    """K2_POS_LAUNCHES a decode under these knobs of `rows` read rows (PE:
    expanded rows, a third of them read1 rows) must make: the sorted-mode
    map on every sorted read row (read1 rows in PE), the paired-end map
    on every rowA and rowB, the rest plain."""
    sorted_rows = ((rows // 3 if pe else rows) if knobs.get("dna_sorted_ctx")
                   else 0)
    pe_rows = 2 * rows // 3 if knobs.get("dna_pe_pos_ctx") else 0
    return {"plain": rows - sorted_rows - pe_rows, "sorted": sorted_rows,
            "pe": pe_rows}


def phase_knobs():
    """The header knobs no CLI flag sets (dna_sorted_ctx, dna_pe_pos_ctx,
    dna_canon 0 with dna_row_global 1): (a) the KNOB_FIXTURES archives
    written on the card == the committed JAX-written files, decoded
    through the CLI's d to the JAX decoder's digests; (b) the KNOBS_FULL
    rows, each archive == the JAX writer's sha256, each decode == the JAX
    decoder's, the larger run of each timed both ways, K1 once a group
    flush at least, K2 once a read row with its position maps as the rows
    take them (K2_POS_LAUNCHES), K3 once a batch with a quality stream;
    (c) K2's position-map instantiations == the plain row step on random
    batches and on the real second batch of each timed archive (the table
    update of row-global context-keyed tables, torch ops after K2,
    included), K2 timed with chain floor, plain version and bound (each
    without that update: k2_compare.plain_row, k2_updates) and the update
    timed apart. Returns (the kernels line's numbers by key, the launches
    by key)."""
    import torch

    from fqsqueezer_tpu_torch.ops import tables
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.tools import k2_compare as k2c

    t0 = time.time()
    _knob_fixtures()
    launches = _knobs_full()
    n_checks = _k2_pos_random()
    out = {}
    for key, name, n in (("sorted", "sorted_ctx", FULL_READS),
                         ("pe", "pe_pos", 50_000),
                         ("canon0", "canon0_rg", FULL_READS)):
        batch = k2c.real_dna_batch(os.path.join(WORK,
                                                f"knobs_{name}_{n}.fqst"))
        rows = k2c.check_rows(*batch, what=f"the {name} batch")
        n_checks += 1
        out[key] = _k2_timed(f"the {name} {n} batch", batch, rows, 1)
        if key == "canon0":
            # the table update after each K2 launch (torch ops)
            ms = _ms(lambda: [dna._apply_sb_updates(
                a[0], tables.LOCAL, a[1].s_tc, a[1].b_tc, want[0][1],
                torch.arange(a[7], device="cuda")[None, :]
                < a[2][:, None]) for a, want in rows], 5)
            print(f"[knobs] the {name} batch's row-end table updates "
                  f"(torch ops after K2, outside K2's time, bound and plain "
                  f"version): {ms:.4f} ms a batch, {ms / len(rows):.4f} ms "
                  f"a row")
            out[key]["torch_update_ms"] = ms
    print(f"[knobs] K2's position maps and the table cells' row-global "
          f"rows exact on {n_checks} batches, tables included; the phase "
          f"took {time.time() - t0:.1f} s")
    return out, launches


def _knob_fixtures():
    """[knobs] (a): each KNOB_FIXTURES archive written on the card == the
    committed file, its decode == the JAX decoder's."""
    sums = _knob_sums()
    for name, flags, knobs, corpus, mesh in KNOB_FIXTURES:
        arc, outs, k1, k2, pos = _knob_fixture(name, flags, knobs, corpus,
                                               mesh)
        with open(arc, "rb") as f, open(os.path.join(
                KNOBS_DIR, f"{name}.fqst"), "rb") as g:
            if f.read() != g.read():
                raise RuntimeError(f"[knobs] {name}: the archive written on "
                                   f"the card differs from the JAX writer's")
        names = ([f"{name}_{k}.fastq" for k in (1, 2)] if len(outs) == 2
                 else [f"{name}.fastq"])
        got = [_sha256(o) for o in outs]
        if got != [sums[x] for x in names]:
            raise RuntimeError(f"[knobs] {name}: decode sha256 {got} != the "
                               f"JAX decoder's")
        rows = (_mesh_rows(arc)[2] if mesh else _batches_and_rows(arc)[1])
        if k1 < 1 or k2 != rows:
            raise RuntimeError(f"[knobs] {name}: K1 launched {k1} times, K2 "
                               f"{k2} times for {rows} read rows")
        print(f"[knobs] fixture {name}: archive == the JAX writer's, decode "
              f"== the JAX decoder's (K1 {k1}, K2 {k2} for {rows} rows, "
              f"maps {pos})")


def _knobs_full():
    """[knobs] (b): the KNOBS_FULL rows; returns the K2 launches of their
    decodes: with the sorted-mode map, with the paired-end map, and of the
    canon0_rg rows."""
    launches = {"sorted": 0, "pe": 0, "canon0": 0}
    for name, knobs, n, flags, want, want_dec in KNOBS_FULL:
        (arc, outs, (stats, dt, peak), k1, (ddt, dpeak), k2, pos, k3,
         lanes) = _knob_full(name, knobs, n, flags)
        groups = _n_groups(arc, lanes)
        sha = _sha256(arc)
        got = tuple(_sha256(o) for o in outs)
        batches, rows = _batches_and_rows(arc)
        qual = flags[flags.index("-qm") + 1] != "n"
        if sha != want or got != want_dec:
            raise RuntimeError(f"[knobs] {name} {n}: archive sha256 {sha} "
                               f"(JAX writer's {want}), decode {got} (JAX "
                               f"decoder's {want_dec})")
        if (k1 < max(1, groups) or k2 != rows
                or k3 != (batches if qual else 0)
                or pos != _want_pos_launches(knobs, "-p" in flags, rows)):
            raise RuntimeError(f"[knobs] {name} {n}: K1 {k1} in {groups} "
                               f"flushes, K2 {k2} for {rows} rows (maps "
                               f"{pos}), K3 {k3} for {batches} batches")
        launches["sorted"] += pos["sorted"]
        launches["pe"] += pos["pe"]
        if name.startswith("canon0"):
            launches["canon0"] += k2
        n_reads = stats["n_reads"]
        print(f"[knobs] {name} {n} {'pairs' if '-p' in flags else 'reads'} "
              f"`{' '.join(flags)}` ({lanes} lanes): archive sha256 == the "
              f"JAX writer's, decode == the JAX decoder's; compress "
              f"{n_reads / dt:.1f} "
              f"reads/s ({dt:.3f} s, {stats['bits_per_base']:.4f} "
              f"bits/base, K1 {k1} in {groups} flushes, peak {peak:.3f} "
              f"GiB), decode {n_reads / ddt:.1f} reads/s ({ddt:.3f} s, K2 "
              f"{k2} for {rows} rows, maps {pos}, K3 {k3}, peak "
              f"{dpeak:.3f} GiB)")
    return launches


def _k2_pos_random():
    """[knobs] (c): K2's position maps == the plain row step on random
    sorted and PE batches; returns the batches checked."""
    import dataclasses

    from fqsqueezer_tpu_torch.tools import k2_compare as k2c
    from fqsqueezer_tpu_torch.utils import dna_batches as db

    n_checks = 0
    for seed, (N, r_pl, L) in enumerate(K2_POS_SORTED_SHAPES):
        cfg = dataclasses.replace(db.bench_dna_config(N),
                                  smer_log2_buckets=db.LOG2_BUCKETS,
                                  bmer_log2_buckets=db.LOG2_BUCKETS,
                                  sorted_ctx=True)
        *batch, lcp = db.dna_decode_inputs(60 + seed, N, r_pl, L, "cuda",
                                           sorted_reads=True, cfg=cfg)
        rows = k2c.check_rows(*batch, L, lcp, what=f"the sorted-mode map, "
                                                   f"N={N} r_pl={r_pl}")
        if not all(a[11] is not None for a, _ in rows):
            raise RuntimeError("[knobs] a sorted row without its map")
        n_checks += 1
    for seed, (N, r_pl, L) in enumerate(K2_POS_PE_SHAPES):
        cfg, st, specs, words, init, _ = db.pe_row_inputs(
            70 + seed, N, r_pl, L, "cuda", pe_pos_ctx=True)
        k2c.check_spec_rows(cfg, st, specs, words, init, L,
                            what=f"the paired-end map, N={N}")
        n_checks += 1
    return n_checks


def _batches_and_rows(arc):
    """(batches, read rows) an archive holds (the port's own reader): one
    K3 launch a batch, one K2 launch a read row (an expanded row, with the
    PE anchors)."""
    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.archive import ArchiveReader
    from fqsqueezer_tpu_torch.params import Params

    rd = ArchiveReader(arc)
    try:
        p = Params.load_params(rd.header_blob)
        dcfg, _, mcfg, _ = pipeline.make_configs(p)
        # PE: whole pairs a batch; with the anchors, 3 rows a pair
        align = p.n_lanes * mcfg.lcp_stride
        first = pipeline._first_batch(p.n_lanes, p.max_batch_reads, 0,
                                      align)
        batches = rows = 0
        while (g := rd.read_group(p.n_lanes)) is not None:
            batches += len(g[1])
            for take, _, _ in g[1]:
                padded = pipeline.canonical_padded(
                    take, first, p.max_batch_reads, align)
                if dcfg.pe_log2_buckets > 0:
                    padded = 3 * (padded // 2)
                rows += padded // p.n_lanes
    finally:
        rd.close()
    return batches, rows


def _decompress(n_reads):
    """(sha256 of the FASTQ, seconds, K3 launches, batches, K2 launches,
    read rows, n_reads) of one pipeline.decompress_file on the card (no
    device named: the default)."""
    import torch

    from fqsqueezer_tpu_torch import pipeline
    from fqsqueezer_tpu_torch.params import Params
    from fqsqueezer_tpu_torch.streams import dna, quality

    _, arc = _corpus(n_reads)
    out = os.path.join(WORK, f"bench_{n_reads}.dec.fastq")
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.time()
    stats = pipeline.decompress_file(Params(), arc, out)
    torch.cuda.synchronize()
    dt = time.time() - t0
    batches, rows = _batches_and_rows(arc)
    _check_scans(arc, f"decode {n_reads}")
    return (_sha256(out), dt, quality.K3_LAUNCHES, batches, dna.K2_LAUNCHES,
            rows, stats["n_reads"])


def phase_decode():
    """The 20k archive through the CLI's d (no --device: the card), the
    100k one through pipeline.decompress_file, warm-up + timed run."""
    import torch

    from fqsqueezer_tpu_torch import cli
    from fqsqueezer_tpu_torch.streams import dna, quality

    _, arc = _corpus(DIGEST_READS)
    out = os.path.join(WORK, f"bench_{DIGEST_READS}.dec.fastq")
    _reset_launches()
    t0 = time.time()
    rc = cli.main(["d", "-v", "1", "-out", out, arc])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = quality.K3_LAUNCHES
    k2_launches = dna.K2_LAUNCHES
    batches, rows = _batches_and_rows(arc)
    if rc != 0:
        raise RuntimeError(f"the CLI's d returned {rc}")
    _check_scans(arc, f"decode {DIGEST_READS}")
    sha = _sha256(out)
    if sha != DIGEST_D20K:
        raise RuntimeError(f"decoded 20k FASTQ sha256 {sha} != reference "
                           f"decoder's {DIGEST_D20K}")
    if launches < batches:
        raise RuntimeError(f"K3 launched {launches} times for {batches} "
                           f"batches")
    if k2_launches != rows:
        raise RuntimeError(f"K2 launched {k2_launches} times for {rows} "
                           f"read rows")
    print(f"[decode] {DIGEST_READS} reads through the CLI's d: sha256 "
          f"{sha} == reference decoder; K3 launches {launches} for "
          f"{batches} batches, K2 launches {k2_launches} for {rows} read "
          f"rows, {dt:.2f} s")

    _decompress(FULL_READS)                        # warm-up
    torch.cuda.reset_peak_memory_stats()
    sha, dt, launches, batches, k2_launches, rows, n = _decompress(FULL_READS)
    peak = torch.cuda.max_memory_allocated()
    if sha != DIGEST_D100K:
        raise RuntimeError(f"decoded 100k FASTQ sha256 {sha} != reference "
                           f"decoder's {DIGEST_D100K}")
    if launches < batches or k2_launches != rows or n != FULL_READS:
        raise RuntimeError(f"K3 launched {launches} times for {batches} "
                           f"batches, K2 {k2_launches} times for {rows} read "
                           f"rows; {n} reads decoded")
    print(f"[decode] {n} reads: {n / dt:.1f} reads/s, wall {dt:.3f} s, "
          f"peak CUDA memory {peak / 2**30:.3f} GiB, sha256 == reference "
          f"decoder, K3 launches {launches} for {batches} batches, K2 "
          f"launches {k2_launches} for {rows} read rows")
    return launches, k2_launches


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import fqsqueezer_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run it from the repository root "
                         f"({e})")
    import torch

    t0 = time.time()
    phase_device()
    os.makedirs(WORK, exist_ok=True)
    phase_build()
    k1 = phase_k1()
    phase_digest()
    launches = phase_full()
    k3_launches = phase_modes()
    sorted_k1, sorted_k3, sorted_k2 = phase_sorted()
    pe_k1, pe_k2 = phase_pe()
    phase_verify()
    phase_resume()
    phase_mesh()
    mesh_k1 = phase_mesh_write()
    mesh_k1 += phase_mesh_legacy()
    ranks_k1, ranks_k2, ranks_k3 = phase_mesh_ranks()
    mesh_k1 += ranks_k1
    legacy_k2, legacy_k3 = phase_legacy()
    k3 = phase_k3()
    k4 = phase_k4()
    k5 = phase_k5()
    k2 = phase_k2()
    k2.update(phase_k2_legacy())
    knobs_k2, knobs_launches = phase_knobs()
    k3_launches[8], k2_launches = phase_decode()
    k3_launches[8] += sorted_k3
    # the ranks' decodes, by the instantiation each fixture's header runs
    k2_launches += ranks_k2.pop("main", 0)
    sorted_k2 += ranks_k2.pop("sorted", 0)
    pe_k2 += ranks_k2.pop("pe", 0)
    for key, n in ranks_k2.items():
        legacy_k2[key] = legacy_k2.get(key, 0) + n
    for key, n in ranks_k3.items():
        into = k3_launches if isinstance(key, int) else legacy_k3
        into[key] = into.get(key, 0) + n
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "fqsqueezer_tpu"))
    if foreign:
        raise RuntimeError(f"the port's run imported {foreign[:5]}")
    print(f"[done] every phase passed in {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "rans_encode_walk (K1)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/rans_encode.cu",
        "replaces": "fqsqueezer_tpu/ops/rans.py:100",
        "launches": launches + sorted_k1 + pe_k1 + mesh_k1, **k1}, {
        "name": "dna_decode_row (K2)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": k2_launches, **k2["main"]}, {
        "name": "dna_decode_row (K2, sorted order: prefix copy)",
        "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": sorted_k2, **k2["sorted"]}, {
        "name": "dna_decode_row (K2, paired-end: anchored rows)",
        "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": pe_k2, **k2["pe"]}, {
        "name": "dna_decode_row (K2, table cells, batch-frozen: the H0 "
                "header)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": legacy_k2["H0"], **k2["H0"]}, {
        "name": "dna_decode_row (K2, table cells, batch-frozen, sorted "
                "order: the H0 header)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": legacy_k2["H0 sorted"], **k2["H0 sorted"]}, {
        "name": "dna_decode_row (K2, ktable cells, row update: the H6 "
                "header)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": legacy_k2["H6"], **k2["H6"]}] + [{
        "name": f"dna_decode_row (K2, {what}: the {key.split()[0]} header)",
        "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": legacy_k2[key], **k2[key]} for key, what in (
            ("H1", "table cells, local_* tables and DNA deltas"),
            ("H1 sorted", "table cells, local_* tables and DNA deltas, "
                          "sorted order"),
            ("H2", "table cells, local_* tables"),
            ("H4", "ktable cells, batch-frozen, klocal_* tables"))] + [{
        "name": f"dna_decode_row (K2, {what})", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/dna_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/dna.py:1357",
        "launches": knobs_launches[key], **knobs_k2[key]} for key, what in (
            ("sorted", "sorted-mode position map: dna_sorted_ctx"),
            ("pe", "paired-end position map on rowA and rowB: "
                   "dna_pe_pos_ctx"),
            ("canon0", "table cells, row-global, without the row's update "
                       "(torch ops after it, torch_update_ms): dna_canon 0 "
                       "with dna_row_global 1"))] + [{
        "name": f"qual_decode_scan (K3, {n_sym} symbols, {mode})",
        "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/qual_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/quality.py:171",
        "launches": k3_launches[n_sym], **k3[n_sym]}
        for n_sym, mode, _ in K3_MODES] + [{
        "name": f"qual_decode_scan (K3, {n_sym} symbols, {mode}, in-batch "
                f"deltas: the H1 header)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/qual_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/quality.py:171",
        "launches": legacy_k3[key], **k3[f"{n_sym} deltas"]}
        for n_sym, mode, key in ((96, "lossless", "H1"),
                                 (8, "illumina_8", "H1 sorted"))] + [{
        "name": "id_decode_scan (K4)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/slot_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/ids.py:630",
        "launches": SCAN_LAUNCHES["K4"], **k4}, {
        "name": "meta_decode_scan (K5)", "route": "cuda",
        "source": "fqsqueezer_tpu_torch/csrc/slot_decode.cu",
        "replaces": "fqsqueezer_tpu/streams/meta.py:95",
        "launches": SCAN_LAUNCHES["K5"], **k5}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
