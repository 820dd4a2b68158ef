"""Run parameters and mode enums — the port's own copy.

The fields, their defaults, the k-mer tuning table and the archive header
(`store_params` / `load_params`) are fqsqueezer_tpu/params.py's, letter for
letter: an archive header written from these Params is byte-equal to the
reference package's, and either package loads the other's header. The enum
classes are distinct types from the reference package's; their values are
the same strings. The reference file's comments give each knob's history
and the measurements behind its default; here each knob has one line.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import List, Optional


class WorkMode(enum.Enum):
    COMPRESS = "compress"
    DECOMPRESS = "decompress"


class DnaMode(enum.Enum):
    SE_ORIGINAL = "se_original"
    SE_SORTED = "se_sorted"
    PE_ORIGINAL = "pe_original"
    PE_SORTED = "pe_sorted"


class IdMode(enum.Enum):
    LOSSLESS = "lossless"
    INSTRUMENT = "instrument"
    NONE = "none"


class QualityMode(enum.Enum):
    LOSSLESS = "lossless"
    ILLUMINA_8 = "illumina_8"
    ILLUMINA_4 = "illumina_4"
    BINARY = "binary"
    NONE = "none"


# Genome size (Mbp) thresholds -> (prefix_len, pmer_len, smer_len, bmer_len).
_KMER_TUNING = (
    (1, 9, 14, 17, 19),
    (4, 9, 15, 18, 20),
    (16, 10, 15, 18, 21),
    (64, 11, 16, 18, 23),
    (256, 12, 17, 20, 24),
    (1024, 12, 17, 21, 26),
    (4096, 13, 18, 21, 27),
    (16384, 14, 18, 22, 27),
    (65536, 15, 18, 22, 27),
)

# The SIV is a dense per-next-base counter array over 4^siv_len contexts, so
# siv_len is capped independently of pmer_len. Decode-affecting: the
# effective cap rides the archive header (dna_siv_cap, legacy 13).
_SIV_LEN_CAP = 14


@dataclasses.dataclass
class Params:
    work_mode: WorkMode = WorkMode.COMPRESS
    file_names: List[str] = dataclasses.field(default_factory=list)
    tmp_path: str = "./fqs_tmp_"
    out_path: str = "output.fqst"
    out_path2: str = "output2.fqst"

    no_threads: int = 1  # accepted for CLI parity
    genome_size: int = 3100  # Mbp, like the reference CLI's -gs

    dna_mode: DnaMode = DnaMode.SE_SORTED
    id_mode: IdMode = IdMode.INSTRUMENT
    quality_mode: QualityMode = QualityMode.ILLUMINA_8
    quality_thr: int = 20
    duplicates_check: bool = True
    verbosity: int = 1

    # k-mer geometry (auto-tuned from genome_size unless set explicitly)
    prefix_len: int = 14
    pmer_len: int = 13
    smer_len: int = 15
    bmer_len: int = 26

    # id geometry (set at compress time from the data; stored in the header)
    max_id_len: int = 64
    id_n_fields: int = 4   # numeric token fields per id
    id_codec_v: int = 2    # id stream codec version

    # execution geometry
    mesh_dp: int = 1               # data-parallel shards of the writer
    mesh_tp: int = 1               # table shards (decode needs the same mesh)
    n_lanes: int = 1024            # interleaved rANS lanes per batch
    max_batch_reads: int = 4096    # reads per device step (sync interval)
    scale_bits: int = 14           # rANS probability resolution

    # table capacities (log2 of bucket counts), presized from -gs
    smer_log2_buckets: int = 20
    bmer_log2_buckets: int = 20
    pe_log2_buckets: int = 18
    # in-batch local table cells; 0 disables
    local_log2_cells: int = 22
    # in-batch model-delta increment; 0 = off
    local_model_inc: int = 0
    # two-level model mix: coarse pseudo-count budget for young fine
    # contexts (0 = off) and its fade constant
    dna_mix_w: int = 2048
    dna_mix_b: int = 4096
    # sorted-mode LCP-distance position bucket
    dna_sorted_ctx: int = 0
    # greedy repair iterations; global-table claim rounds per update;
    # whether local tables also ingest the reverse-complement strand
    dna_repair_iters: int = 1
    dna_claim_rounds: int = 0
    dna_local_rc: int = 1
    # 2-pass local inserts (no ownership gather)
    dna_local_lite: int = 1
    # pmer-level position gate; 0 = ungated
    dna_pmer_gate: int = 0
    # read-prefix partial-SIV ramp (single-device paths only)
    dna_prefix_ramp: int = 1
    # effective dense-SIV length cap (older archives were written at 13)
    dna_siv_cap: int = _SIV_LEN_CAP
    # canonical-strand s/b-mer tables; legacy archives decode with 0
    dna_canon: int = 1
    # DNA code-context layout version; legacy archives decode with 1
    dna_ctx_v: int = 2
    # PE-aware position contexts for the anchored 3-row recoding
    dna_pe_pos_ctx: int = 0
    # suspect-tracked 1-substitution s-mer miss evidence; applies only with
    # row_global + canon + ctx_v >= 2 (gated in make_configs)
    dna_rough: int = 1
    # s/b table update protocol: 1 = single-word cells, one gather + one
    # scatter-max per update; legacy archives decode with 0
    dna_sb_proto: int = 1
    # coarse letters-branch position bucket; legacy archives decode with 0
    dna_let_pb2: int = 1
    # owner-routed mesh s/b update exchange; mesh archives only
    mesh_route_sb: int = 0
    # PE anchor machinery on the mesh; legacy mesh PE archives load 0
    dna_pe_mesh: int = 1
    # row-global s/b-mer updates: the global tables evolve at read-row
    # granularity inside each batch, replacing the in-batch local tables
    # (local_log2_cells is then ignored); legacy archives decode with 0
    dna_row_global: int = 1

    def auto_tune_lanes(self) -> None:
        """Mode-tuned rANS lane count, called by the product entry points
        after the mode flags settle: SE original order with a quality
        stream widens to 2048 lanes; every other mode keeps 1024. The count
        rides the archive header, so decode follows whatever the writer
        chose; callers that set n_lanes explicitly skip this."""
        if (self.n_lanes == 1024 and self.dna_mode == DnaMode.SE_ORIGINAL
                and self.quality_mode != QualityMode.NONE):
            self.n_lanes = 2048

    def adjust_kmer_sizes(self) -> None:
        """Auto-pick k-mer lengths and table sizes from the genome size."""
        for thr, prefix, pmer, smer, bmer in _KMER_TUNING:
            if self.genome_size <= thr:
                self.prefix_len = prefix
                self.pmer_len = pmer
                self.smer_len = smer
                self.bmer_len = bmer
                break
        # scale hash tables with genome size: ~2 cells per genome base
        gbases = self.genome_size * 1_000_000
        want = max(16, min(26, int(math.ceil(math.log2(max(1, gbases) / 4)))))
        # canonical tables hold 4 cells/bucket (tables.KBUCKET) against the
        # legacy 8: one extra bucket bit keeps the cell capacity. Hard cap
        # 2^26 buckets a table.
        extra = 1 if self.dna_canon > 0 else 0
        self.smer_log2_buckets = min(26, want + extra)
        self.bmer_log2_buckets = self.smer_log2_buckets
        self.pe_log2_buckets = max(14, want - 2)

    @property
    def siv_len(self) -> int:
        return min(self.pmer_len, self.dna_siv_cap)

    # --- archive header (self-describing) ---
    _HDR_KEYS = (
        "dna_mode", "id_mode", "quality_mode", "quality_thr",
        "duplicates_check", "prefix_len", "pmer_len", "smer_len", "bmer_len",
        "max_id_len", "id_n_fields", "id_codec_v",
        "mesh_dp", "mesh_tp",
        "n_lanes", "max_batch_reads", "scale_bits",
        "smer_log2_buckets", "bmer_log2_buckets", "pe_log2_buckets",
        "local_log2_cells", "local_model_inc",
        "dna_mix_w", "dna_mix_b", "dna_sorted_ctx",
        "dna_repair_iters", "dna_claim_rounds", "dna_local_rc",
        "dna_pmer_gate", "dna_siv_cap", "dna_prefix_ramp",
        "dna_local_lite", "dna_canon", "dna_row_global", "dna_pe_pos_ctx",
        "dna_ctx_v", "dna_pe_mesh", "dna_rough", "dna_sb_proto",
        "mesh_route_sb", "dna_let_pb2",
    )

    # decode-affecting params whose absence in an archive header means the
    # writer predates the feature (NOT "use the current default")
    _HDR_LEGACY = {"local_log2_cells": 0, "local_model_inc": 8,
                   "id_codec_v": 1, "dna_mix_w": 0, "dna_mix_b": 64,
                   "dna_sorted_ctx": 0, "dna_repair_iters": 3,
                   "dna_claim_rounds": 2, "dna_local_rc": 1,
                   "dna_pmer_gate": 0, "dna_siv_cap": 13,
                   "dna_prefix_ramp": 0, "dna_local_lite": 0,
                   "dna_canon": 0, "dna_row_global": 0, "dna_pe_pos_ctx": 0,
                   "dna_ctx_v": 1, "dna_pe_mesh": 0, "dna_rough": 0,
                   "dna_sb_proto": 0, "mesh_route_sb": 0, "dna_let_pb2": 0}

    def store_params(self) -> bytes:
        d = {}
        for k in self._HDR_KEYS:
            v = getattr(self, k)
            d[k] = v.value if isinstance(v, enum.Enum) else v
        return json.dumps(d, sort_keys=True).encode()

    @classmethod
    def load_params(cls, blob: bytes, base: Optional["Params"] = None) -> "Params":
        d = json.loads(blob.decode())
        p = dataclasses.replace(base) if base else cls()
        for k in cls._HDR_KEYS:
            if k not in d:  # archive from an older writer
                if k in cls._HDR_LEGACY:
                    setattr(p, k, cls._HDR_LEGACY[k])
                continue
            v = d[k]
            cur = getattr(p, k)
            if isinstance(cur, enum.Enum):
                v = type(cur)(v)
            setattr(p, k, v)
        return p


# The header generations of the older writers whose archives the port
# decodes and writes: the knob values each writer stored or, where its
# header lacked a key, the value load_params gives it. H0, the first
# writer: no knob key at all, so exactly _HDR_LEGACY (batch-frozen
# context-keyed table_* tables, ctx v1, id codec v1). H1-H4 keep in-batch
# local statistics beside batch-frozen tables: H1 (its header has
# local_log2_cells but not local_model_inc, which loads 8) local_* tables
# of 2^22 cells and DNA and quality model deltas; H2 no deltas, id codec
# v2, the two-level mix, the prefix ramp and SIV cap 14; H3 2-pass local
# inserts, the fused table update and one repair; H4 canonical ktable_*
# tables and klocal_* local tables. H5, the first row-global writer:
# canonical tables with u16 counters (dna_sb_proto 0), ctx v1, no rough
# rescue, fine letters' position buckets. H6: H5 with ctx v2 and the rough
# rescue.
_H1 = dict(Params._HDR_LEGACY, local_log2_cells=22)
_H2 = dict(_H1, local_model_inc=0, id_codec_v=2, dna_mix_w=2048,
           dna_mix_b=4096, dna_siv_cap=14, dna_prefix_ramp=1)
_H3 = dict(_H2, dna_local_lite=1, dna_claim_rounds=0, dna_repair_iters=1)
_H5 = {"dna_pe_pos_ctx": 0, "dna_ctx_v": 1, "dna_pe_mesh": 0,
       "dna_rough": 0, "dna_sb_proto": 0, "mesh_route_sb": 0,
       "dna_let_pb2": 0}
HEADER_GENERATIONS = {
    "H0": dict(Params._HDR_LEGACY),
    "H1": _H1,
    "H2": _H2,
    "H3": _H3,
    "H4": dict(_H3, dna_canon=1),
    "H5": _H5,
    "H6": dict(_H5, dna_ctx_v=2, dna_rough=1),
}


def header_generation(p: Params, gen: str) -> Params:
    """p with the header knobs of an older writer (HEADER_GENERATIONS),
    its k-mer geometry re-tuned from p.genome_size as that writer did
    (adjust_kmer_sizes: the context-keyed tables of H0 take one bucket bit
    fewer than canonical ones). Changes p in place and returns it."""
    for k, v in HEADER_GENERATIONS[gen].items():
        setattr(p, k, v)
    p.adjust_kmer_sizes()
    return p
