// K2: one read row of the DNA decode scan — every position, every lane —
// in one launch.
//
// Replaces the XLA scan of fqsqueezer_tpu/streams/dna.py: dna_decode_batch
// (its `outer` scan over read rows around the `inner` step over positions;
// the JAX package has no Pallas kernel on the decode side). Its plain
// version is streams/dna.py:dna_decode_row_plain, step for step, for every
// header the JAX writer stores. Template parameters: the s/b table
// family (kFam: K2 cells, rows of 4 tag24|count8 words; ktable cells, 6-word
// rows of 4 tags and 4 u16 counters; or the first writer's context-keyed
// table cells, 16-word rows of 8 tags and 8 u8x4 count words; each u32 word
// held in an int64), whether the row updates the tables (kRowUpdate:
// row-global headers; batch-frozen ones update them once a batch, outside
// the kernel), sorted order's prefix copy (kLcp), whether the header's
// knobs are the JAX writer's of today (kToday: compile-time constants;
// otherwise the knobs, uniform over a launch, come in Args), and the
// in-batch local statistics of the headers without row-global updates
// (kLoc: none; local_* tables of context-keyed cells, 5-word rows; the
// same with the DNA model's deltas; klocal_* tables keyed by the canonical
// middle, 9-word rows of 16 u16 counters; the same with the deltas), and
// on rows that copy prefixes or anchors the position map of the contexts'
// buckets (kPos: none; sorted mode's distance past the lane's LCP; read2's
// coordinates on rowA and rowB). For lane n at position i of the row:
//   finds    SIV word of pkey (at i < pmer_gate when the gate is set); the
//            s and b queries — canonical (canon strand, hash bucket and
//            tag, 4 end-letter slots) or, in context-keyed tables, the
//            forward (k-1)-base window's bucket and tag — one table row
//            each, the bucket widened by the tag's growth bits when the
//            table has grown
//   ramp     with the prefix ramp, at prefix_len <= i < siv_len-1 the SIV
//            ranges of the decoded prefix replace the SIV counts (SWAR
//            byte folds)
//   local    (kLoc) one local cell for the s query and one for the b
//            query, tag-checked: the forward window's (context-keyed) or
//            the canonical middle's (klocal: the 4 candidates' end-letter
//            slots); their counts add to the s and b finds' and a nonzero
//            one makes the level found (dna._merge_local). The local
//            state is the batch's, as the rows before this one left it:
//            read only here, updated between launches (local_row_update)
//   combine  the cascade (b, mixed, s, SIV); with the rough rescue, at i >=
//            s_w: srun counts s/b misses, 3 single-base substitutions of
//            the s window at the suspect offset, one s find each
//   context  sorted counts quantized, position bucket (of i, or mapped:
//            kPos), rank-miss history,
//            previous level class (ctx v2), in the layout of the header
//            (rough: 23 bits, v2: 22, v1: 20); or the letters context,
//            its position bucket coarse (pb >> 2) under let_pb2
//   cdf      with the model's deltas (kLoc), the fine row's cells take
//            min(lm[ctx], local_cap) first; with the two-level mix, fine
//            row ctx and coarse row mixed: w_eff = w*b/(tf+b), cells f +
//            g*w_eff/(tg+A) + 1; without it cells f + 1; boundaries (cum
//            << SB) / total
//   decode   the masked max/min lookup, x = f*(x >> SB) + slot - c, and the
//            lanes that renormalize take consecutive words of ONE stream in
//            lane order: an exclusive scan over all N lanes at every step
//   prefix   sorted mode: at i < lcp[n] (the prefix the read shares with
//            the previous read of its lane) the position is not coded — no
//            word, x unchanged — and its base is copied from src[n, i], the
//            previous row's base plane; everything else of the step (the
//            finds, the context and the lookup, repair, the events, the
//            rolls) runs as at a coded position, and the rank history
//            counts coded positions only. A template parameter (kLcp)
//            keeps the prefix code out of original order's kernel.
//   repair   on the table finds' counts (before the rough rescue and the
//            local counts), at most repair_iters times a row; then the
//            rolls of pkey, the s/b windows, their reverse complements,
//            the letters and rank histories
//   out      base, eff (kc), ctx and sym of position i, int64 [N, L]
//   events   (kRowUpdate) at i >= k - 1 (k = smer_len, then bmer_len) and
//            i < length: the row's canonical s-mer and b-mer insert event,
//            whose key is the find's own query with the decoded kc as its
//            candidate; its update decision is taken from the cells the
//            find loaded
// and after the row's last position, the row's s/b table update (the end
// of the reference's `outer` step, _apply_sb_updates): every decision was
// taken against the row-start tables, one cluster barrier follows the
// scan, and then every lane applies its decisions to the tables with
// atomics, in place. K2 cells: k2_update's one gather and one scatter-max,
// as 64-bit atomicMax of (cell index, new word): duplicate events of one
// key raise its count once, new keys that pick one empty slot leave the
// larger word, a new key whose row-start bucket is full is dropped, counts
// saturate at 255. ktable cells: ktable_update's claim and add, as a
// 32-bit atomicMax of the tag into the claimed cell and a 32-bit atomicAdd
// of 1 << 16*(cell & 1) into the counter word of the decided cell; the add
// goes there even where another key won the claim, and a counter at 0xFFFF
// carries into its neighbour or out of the word, as the reference's u32
// add does (the low half of the int64 word, whose high half stays 0).
// x, ptr, pkey and the six window registers carry in and out (across rows,
// as the reference's outer carry); lh, rh, rep_cnt, prevc and srun start
// afresh each row. At i >= k - 1 the masked window registers hold only
// this row's bases, so the events equal dna.sb_canon_events of the row's
// kc plane (a CPU test restates the enumeration).
//
// What bounds it on an H100: neither bytes nor operations over the card
// (a row reads a few MB of table rows and writes 7 MB of planes: some
// microseconds at 3.35 TB/s). The time is the chain: L dependent steps,
// each a handful of dependent loads (the finds and the rough probes, then
// two model rows, then the word), a few hundred to a few thousand integer
// instructions a lane, and one barrier across every lane. The design:
//  * One lane a thread, 128 threads a block, the lanes spread
//    over a thread-block cluster of ceil(N/128) <= 16 blocks on as many SMs
//    (a non-portable cluster size, which the H100 takes). A thread has up
//    to 255 registers for a lane's state and temporaries, and sixteen SMs
//    issue the lanes' work (with 256 lanes a block on eight SMs, issue cost
//    more than the chain: PERF.md).
//  * The scan (cluster_scan.cuh, shared with K3): each warp's ballot count
//    is stored into every block of the cluster, double-buffered by step
//    parity, then ONE cluster barrier a step; each warp scans the at most
//    64 warp totals from its own shared memory with shuffles.
//  * Tables are read in place: a table row as 16-byte loads (two for K2,
//    three for ktable, eight for table rows), the SIV word and the model's
//    20-byte rows as 4-byte loads. Masked lanes read no
//    table row, but still read the letters context's model rows: the plain
//    version writes the looked-up symbol of every lane.
//  * The rough probes' three s rows are loaded beside the finds' rows,
//    before the finds tell whether the step misses, whenever a miss would
//    probe (the lane's miss run is shorter than s_w): their latencies
//    overlap, and a step took 17% less time than with the probes loaded
//    after the finds (PERF.md).
//  * The row's table update costs no gather of its own: the s and b cells
//    the step's finds loaded stay in registers until kc is known. The
//    decisions wait in a global scratch plane [2, L, N] (coalesced u64
//    stores, L2-resident: 3.4 MB at N = 2048, L = 104), since a row's 171
//    events a lane would not fit a block's shared memory; a lane loads
//    eight of them at once, then issues their atomics
//    (fire-and-forget reductions).
// Preconditions (the wrapper checks the shapes and 0 <= lcp <= length; the
// other values are what the codec stores): table words, SIV words, states
// and window registers are u32 values (the registers masked to their
// windows); model rows are model_update's, smoothed totals at most 2^13, so
// with w*b < 2^31 and w <= 2^18 every product and boundary of the cdf fits
// 32 bits (the deltas' cap, models.local_cap, keeps a row's total at most
// 2^SB); the s and b tables do not overlap (they are updated in place).
#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLanes = 2048;      // K2_MAX_LANES in streams/dna.py
constexpr int kThreads = 128;        // lanes a block
// events a lane loads at once in the row's table update, before it issues
// their atomics
constexpr int kEventBatch = 8;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kMaxLanes / kThreads <= 16 &&
                  kMaxLanes / 32 <= fqtz::kScanMaxWarps,
              "a cluster of at most 16 blocks holds every lane");
constexpr int kA = 5;                // symbols a model row: 4 ranks + N
constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kC1 = 0x9E3779B1u, kC2 = 0x85EBCA77u, kC3 = 0xC2B2AE3Du,
                   kC4 = 0x27D4EB2Fu, kC5 = 0x165667B1u;
constexpr int kNone = 0, kPmer = 1, kSmer = 2, kMixed = 3, kBmer = 4,
              kRsmer = 5;
constexpr uint32_t kLhMask = (1u << 15) - 1u;
constexpr uint32_t kLhReset = 0b101101101101101u;
constexpr int kLetBits = 19;         // LET_CTX_BITS
// the s/b table families (dna.FAMILIES) and their row widths in words
constexpr int kFamK2 = 0, kFamKtable = 1, kFamTable = 2;
template <int kFam>
__host__ __device__ constexpr int row_words() {
  return kFam == kFamK2 ? 4 : kFam == kFamKtable ? 6 : 16;
}
// the in-batch local statistics (dna.K2_LOCAL), their cells' width in
// words, and the stored tag's mask (tables.LOCAL_TAG_MASK)
constexpr int kLocNone = 0, kLocTable = 1, kLocTableDeltas = 2,
              kLocK = 3, kLocKDeltas = 4;
template <int kLoc>
__host__ __device__ constexpr int local_words() {
  return kLoc >= kLocK ? 9 : 5;
}
constexpr uint32_t kLocalTagMask = (1u << 27) - 1u;
// a row's position map (dna.K2_POS)
constexpr int kPosNone = 0, kPosSorted = 1, kPosPe = 2;

// The launch's arguments, in the order of K2_ARGS in streams/dna.py.
struct Args {
  const int64_t* siv;       // [4^(siv_len-1)] u32 words
  int64_t* s_tc;            // [2^s_log2_rows, row_words] u32 words
  int64_t* b_tc;            // [2^b_log2_rows, row_words]; row-global:
                            // updated in place
  const int32_t* model;     // [n_model_ctx (+ n_coarse_ctx with the mix), 5]
  const int64_t* lengths;   // [N]
  const int32_t* words;     // [n_words] u16 values
  const int64_t* x_in;      // [N]
  const int64_t* ptr_in;    // [1]
  const int64_t* regs_in;   // [9, N]
  // sorted mode: this row's prefix lengths [N] (0 <= lcp <= length) and the
  // previous row's base plane [N, L]; both null in original order
  const int64_t* lcp;
  const int64_t* src;
  int64_t* base;            // [N, L]
  int64_t* kc;
  int64_t* ctx;
  int64_t* sym;
  int64_t* x_out;           // [N]
  int64_t* ptr_out;         // [1]
  int64_t* regs_out;        // [9, N]
  int64_t n_words, N, L, siv_len, smer_len, bmer_len, prefix_len, sb;
  int64_t s_log2_rows, s_log2_base, b_log2_rows, b_log2_base, mix_w, mix_b;
  uint64_t* events;         // [2, L, N] scratch: the s, then b decisions
  // the header's knobs: the table family (kFam), whether the row updates
  // the tables (kRowUpdate), the context version, the rough rescue, coarse
  // letters' position buckets, the prefix ramp, the pmer gate (0: none),
  // repairs a row
  int64_t family, row_update, ctx_v, rough, let_pb2, prefix_ramp, pmer_gate,
      repair_iters;
  // the in-batch local statistics (headers without row-global updates):
  // the s and b local tables [2^local_log2_cells, 5 or 9] u32 words, the
  // DNA model's deltas [n_model_ctx, 5] (null without them), which of
  // dna.K2_LOCAL (kLoc), and the deltas' cap (models.local_cap)
  const int64_t* ls;
  const int64_t* lb;
  const int32_t* lm;
  int64_t local, local_log2_cells, local_cap;
  // the row's position map (dna.K2_POS, kPos), on rows that copy prefixes
  // or anchors (kLcp): 0 none; 1 sorted mode, pos_off the lanes' LCPs [N];
  // 2 paired-end, position max(pos_off + pos_sign * i, 0) of a read of
  // length pos_len, pos_off and pos_len [N], pos_sign +1 or -1. Null
  // pointers without a map.
  int64_t pos;
  const int64_t* pos_off;
  const int64_t* pos_len;
  int64_t pos_sign;
};
constexpr int kNArgs = sizeof(Args) / sizeof(int64_t);
static_assert(sizeof(void*) == sizeof(int64_t), "64-bit pointers");
// regs rows: pkey, slo, shi, blo, bhi, rslo, rshi, rblo, rbhi (u32 halves)

__device__ __forceinline__ uint64_t bases_mask(int n) {
  return n >= 32 ? ~0ull : (1ull << (2 * n)) - 1ull;
}

__device__ __forceinline__ uint32_t hash_bucket(uint32_t lo, uint32_t hi,
                                                int log2b) {
  uint32_t h = (lo * kC1) ^ (hi * kC2);
  h ^= h >> 15;
  h *= kC3;
  h ^= h >> 13;
  return h & ((1u << log2b) - 1u);
}

__device__ __forceinline__ uint32_t hash_tag(uint32_t lo, uint32_t hi) {
  uint32_t t = (lo * kC4) ^ (hi * kC5);
  t ^= t >> 16;
  t *= kC1;
  t ^= t >> 11;
  return t | 0x80000000u;
}

// A query of a width-k table: its (grown) bucket row and each candidate's
// cell tag (K2: tables.k2tag << 8; ktable: the 32-bit tag); a
// context-keyed table's query has one tag, tw[0].
struct Query {
  uint32_t row;
  uint32_t tw[4];
};

// The canonical query, c: the (k-1)-base context window, r: its reverse
// complement.
template <int kFam>
__device__ __forceinline__ Query canon_query(uint64_t c, uint64_t r, int k,
                                             int log2_base, int log2_rows) {
  const uint64_t m = bases_mask(k - 2);
  const uint64_t w = c & m;
  const uint64_t rw = (r >> 2) & m;
  const bool s = rw < w;
  const uint64_t mid = s ? rw : w;
  const uint32_t mlo = static_cast<uint32_t>(mid);
  const uint32_t mhi = static_cast<uint32_t>(mid >> 32);
  const uint32_t mt = hash_tag(mlo, mhi) & ~0xFu;
  const uint32_t c0 = static_cast<uint32_t>(c >> (2 * (k - 2))) & 3u;
  Query q;
  q.row = hash_bucket(mlo, mhi, log2_base);
  const int grow = log2_rows - log2_base;
  if (grow > 0) q.row |= ((mt >> 23) & ((1u << grow) - 1u)) << log2_base;
  const uint32_t twb = (((mt >> 23) & 0xFu) << 4 |
                        ((mt >> 4) & 0x7FFFu) << 8 | 1u << 23) << 8;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t slot = s ? 4u * (3u - b) + (3u - c0) : 4u * c0 + b;
    q.tw[b] = kFam == kFamK2 ? twb | slot << 8 : mt | slot;
  }
  return q;
}

// The context-keyed query (tables.table_find): the window c's (lo, hi)
// halves hash to the bucket at creation size, widened by the tag's bits
// [23, 27) once the table has grown.
__device__ __forceinline__ Query context_query(uint64_t c, int log2_base,
                                               int log2_rows) {
  const uint32_t lo = static_cast<uint32_t>(c);
  const uint32_t hi = static_cast<uint32_t>(c >> 32);
  Query q = {};
  q.tw[0] = hash_tag(lo, hi);
  q.row = hash_bucket(lo, hi, log2_base);
  const int grow = log2_rows - log2_base;
  if (grow > 0) q.row |= ((q.tw[0] >> 23) & ((1u << grow) - 1u)) << log2_base;
  return q;
}

// The s or b query of a family: canonical, or context-keyed.
template <int kFam>
__device__ __forceinline__ Query make_query(uint64_t c, uint64_t r, int k,
                                            int log2_base, int log2_rows) {
  if constexpr (kFam == kFamTable) {
    return context_query(c, log2_base, log2_rows);
  } else {
    return canon_query<kFam>(c, r, k, log2_base, log2_rows);
  }
}

// One bucket row of a table: its row_words<kFam>() u32 words, as 16-byte
// loads of int64 pairs.
template <int kFam>
__device__ __forceinline__ void load_cells(const int64_t* tc, uint32_t row,
                                           uint32_t* cell) {
  constexpr int kW = row_words<kFam>();
  const longlong2* p = reinterpret_cast<const longlong2*>(tc) +
                       (kW / 2) * static_cast<size_t>(row);
#pragma unroll
  for (int k = 0; k < kW / 2; ++k) {
    const longlong2 a = __ldg(p + k);
    cell[2 * k] = static_cast<uint32_t>(a.x);
    cell[2 * k + 1] = static_cast<uint32_t>(a.y);
  }
}

// The find on a loaded row (tables.k2_find, ktable_find, table_find): the 4
// candidates' counts; returns whether any cell matched.
template <int kFam>
__device__ __forceinline__ bool row_count(const uint32_t* cell,
                                          const Query& q, uint32_t cnt[4]) {
  bool found = false;
  if constexpr (kFam == kFamTable) {
    // the matching cells' u8x4 count words, summed as u32
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cell[j] == q.tw[0]) {
        word += cell[8 + j];
        found = true;
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) cnt[b] = (word >> (8 * b)) & 0xFFu;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cnt[c] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kFam == kFamK2) {
          if ((cell[j] & 0xFFFFFF00u) == q.tw[c]) {
            cnt[c] += cell[j] & 0xFFu;
            found = true;
          }
        } else if (cell[j] == q.tw[c]) {   // a u16 counter, clipped to 255
          const uint32_t c16 = (cell[4 + j / 2] >> (16 * (j & 1))) & 0xFFFFu;
          cnt[c] += c16 < 255u ? c16 : 255u;
          found = true;
        }
      }
    }
  }
  return found;
}

// The query of rough probe k (0..2): the s window Sm (its reverse
// complement RS) with the base at offset `age` replaced by the k-th of the
// three others.
template <int kFam>
__device__ __forceinline__ Query rough_query(uint64_t Sm, uint64_t RS,
                                             int age, uint32_t k, int s_w,
                                             int smer, int lb, int lr) {
  const int a2 = 2 * age;
  const int d2 = 2 * (s_w - 1 - age);
  const uint32_t orig = static_cast<uint32_t>(Sm >> a2) & 3u;
  const uint32_t ju = k + (orig <= k ? 1u : 0u);
  const uint64_t Sj = (Sm & ~(3ull << a2)) | static_cast<uint64_t>(ju) << a2;
  const uint64_t Rj = (RS & ~(3ull << d2)) |
                      static_cast<uint64_t>(3u - ju) << d2;
  return canon_query<kFam>(Sj, Rj, smer, lb, lr);
}

// The local cell of a query (tables.local_keys): the forward window c's
// (lo, hi) halves, or with canonical (klocal) tables the middle of the
// canonical strand (c, r as in canon_query), hashed to a cell and a 27-bit
// tag with bit 26 set; s and c0 give the end-letter slots of klocal.
struct LocalKey {
  uint32_t cell, tag, s, c0;
};

template <int kLoc>
__device__ __forceinline__ LocalKey local_key(uint64_t c, uint64_t r, int k,
                                              int log2_cells) {
  LocalKey q = {};
  uint64_t key = c;
  if constexpr (kLoc >= kLocK) {
    const uint64_t m = bases_mask(k - 2);
    const uint64_t w = c & m;
    const uint64_t rw = (r >> 2) & m;
    q.s = rw < w ? 1u : 0u;
    key = q.s ? rw : w;
    q.c0 = static_cast<uint32_t>(c >> (2 * (k - 2))) & 3u;
  }
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  q.cell = hash_bucket(lo, hi, log2_cells);
  q.tag = (hash_tag(lo, hi) & kLocalTagMask) | 1u << 26;
  return q;
}

// A local cell's words (read only during the launch).
template <int kLoc>
__device__ __forceinline__ void load_local(const int64_t* t, uint32_t cell,
                                           uint32_t* w) {
  constexpr int kLW = local_words<kLoc>();
  const int64_t* p = t + static_cast<size_t>(cell) * kLW;
#pragma unroll
  for (int k = 0; k < kLW; ++k) w[k] = static_cast<uint32_t>(__ldg(p + k));
}

// tables.local_query / klocal_query on a loaded cell: the 4 candidates'
// counts, zeros on a tag miss; returns whether any count is nonzero.
template <int kLoc>
__device__ __forceinline__ bool local_count(const uint32_t* w,
                                            const LocalKey& q,
                                            uint32_t cnt[4]) {
  const bool hit = (w[0] & kLocalTagMask) == q.tag;
  uint32_t any = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    uint32_t c;
    if constexpr (kLoc >= kLocK) {
      const uint32_t slot =
          q.s ? 4u * (3u - b) + (3u - q.c0) : 4u * q.c0 + b;
      uint32_t word = w[1];
#pragma unroll
      for (uint32_t j = 1; j < 8; ++j) word = (slot >> 1) == j ? w[1 + j] : word;
      c = (word >> (16 * (slot & 1u))) & 0xFFFFu;
    } else {
      c = w[1 + b];
    }
    cnt[b] = hit ? c : 0u;
    any |= cnt[b];
  }
  return any != 0;
}

// The tag word of candidate b (a register select, not an indexed array).
__device__ __forceinline__ uint32_t tag_word(const Query& q, uint32_t b) {
  uint32_t tw = q.tw[0];
#pragma unroll
  for (uint32_t c = 1; c < 4; ++c) tw = b == c ? q.tw[c] : tw;
  return tw;
}

// tables.k2_update's decision for one insert event (tag word tw) against
// its bucket row's row-start cells: (cell index << 32 | new cell), or 0
// when the key is new and the row has no empty cell (the event is
// dropped). A found key writes the sum of its matching cells + 1 (the
// first match's index; the count saturates at 255); a new key writes
// tw | 1 into the first empty cell after rotating the empty mask by
// j = ((tag >> 13) ^ tag) & 3 — tag bits 13-14 sit at tw bits 25-26, its
// slot bits 0-1 at tw bits 8-9.
__device__ __forceinline__ uint64_t k2_decide(const uint32_t cell[4],
                                              uint32_t row, uint32_t tw) {
  uint32_t sum = 0, bm = 0, d = 4;
#pragma unroll
  for (int c = 3; c >= 0; --c) {
    if ((cell[c] & 0xFFFFFF00u) == tw) {
      sum += cell[c];
      d = c;
    }
    bm |= (cell[c] == 0u ? 1u : 0u) << c;
  }
  uint32_t v;
  if (d < 4) {
    v = sum + ((sum & 0xFFu) < 0xFFu ? 1u : 0u);
  } else {
    if (bm == 0) return 0;
    const uint32_t j = ((tw >> 25) ^ (tw >> 8)) & 3u;
    const uint32_t rot = ((bm >> j) | (bm << (4u - j))) & 0xFu;
    d = (j + static_cast<uint32_t>(__ffs(rot)) - 1u) & 3u;
    v = tw | 1u;
  }
  return static_cast<uint64_t>(row * 4u + d) << 32 | v;
}

// tables.ktable_update's decision for one insert event (tag tw) against its
// bucket row's row-start cells: (what << 32 | row * 4 + cell), what = 1
// for a found key (its first matching cell: the add only), the tag for a
// new key (the first empty cell after rotating the empty mask by j =
// ((tag >> 13) ^ tag) & 3: the claim and the add; a tag has bit 31 set, so
// it is never 1), or 0 when the key is new and the row has no empty cell
// (the event is dropped).
__device__ __forceinline__ uint64_t kt_decide(const uint32_t cell[6],
                                              uint32_t row, uint32_t tw) {
  uint32_t bm = 0, d = 4;
#pragma unroll
  for (int c = 3; c >= 0; --c) {
    if (cell[c] == tw) d = c;
    bm |= (cell[c] == 0u ? 1u : 0u) << c;
  }
  uint32_t what = 1;
  if (d == 4) {
    if (bm == 0) return 0;
    const uint32_t j = ((tw >> 13) ^ tw) & 3u;
    const uint32_t rot = ((bm >> j) | (bm << (4u - j))) & 0xFu;
    d = (j + static_cast<uint32_t>(__ffs(rot)) - 1u) & 3u;
    what = tw;
  }
  return static_cast<uint64_t>(what) << 32 | (row * 4u + d);
}

template <int kFam>
__device__ __forceinline__ uint64_t decide(const uint32_t* cell, uint32_t row,
                                           uint32_t tw) {
  if constexpr (kFam == kFamK2) {
    return k2_decide(cell, row, tw);
  } else {
    return kt_decide(cell, row, tw);
  }
}

__device__ __forceinline__ void unpack4(uint32_t w, uint32_t c[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) c[b] = (w >> (8 * b)) & 0xFFu;
}

// Number of thresholds <= v (searchsorted right=True over _Q0/_Q1/_Q23).
__device__ __forceinline__ uint32_t quant0(uint32_t v) {
  constexpr uint32_t t[15] = {1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 24, 32, 48,
                              64, 128};
  uint32_t n = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) n += t[k] <= v ? 1u : 0u;
  return n;
}

__device__ __forceinline__ uint32_t quant1(uint32_t v) {
  constexpr uint32_t t[7] = {1, 2, 3, 4, 6, 8, 16};
  uint32_t n = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) n += t[k] <= v ? 1u : 0u;
  return n;
}

__device__ __forceinline__ uint32_t quant23(uint32_t v) {
  return (v >= 1u ? 1u : 0u) + (v >= 2u ? 1u : 0u) + (v >= 4u ? 1u : 0u);
}

__device__ __forceinline__ void swap_desc(uint32_t& p, uint32_t& q) {
  const uint32_t hi = p < q ? q : p;
  q = p < q ? p : q;
  p = hi;
}

// Rank of each base under (count desc, base asc).
__device__ __forceinline__ void ranks_of(const uint32_t c[4], int r[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int n = 0;
#pragma unroll
    for (int o = 0; o < 4; ++o)
      n += (c[o] > c[b] || (o < b && c[o] == c[b])) ? 1 : 0;
    r[b] = n;
  }
}

__device__ __forceinline__ void load_row(const int32_t* __restrict__ model,
                                         uint32_t ctx, uint32_t v[kA]) {
  const int32_t* row = model + static_cast<size_t>(ctx) * kA;
#pragma unroll
  for (int k = 0; k < kA; ++k) v[k] = static_cast<uint32_t>(__ldg(row + k));
}

// One lane's row update into one table: its decisions of positions
// [from, end) (stride N), kEventBatch loads in flight before their
// atomics. K2: (cell << 32 | word), a word of 0 a dropped event; ktable:
// kt_decide's, 0 a dropped event. The atomics work on the u32 value in the
// low half of each int64 word.
template <int kFam>
__device__ __forceinline__ void apply_events(const uint64_t* ev, int64_t* tc,
                                             int from, int end, int N) {
  for (int i0 = from; i0 < end; i0 += kEventBatch) {
    uint64_t e[kEventBatch];
#pragma unroll
    for (int u = 0; u < kEventBatch; ++u)
      e[u] = i0 + u < end ? ev[static_cast<size_t>(i0 + u) * N] : 0ull;
#pragma unroll
    for (int u = 0; u < kEventBatch; ++u) {
      if constexpr (kFam == kFamK2) {
        if (static_cast<uint32_t>(e[u]) != 0u)
          atomicMax(reinterpret_cast<unsigned long long*>(tc) + (e[u] >> 32),
                    e[u] & 0xFFFFFFFFull);
      } else if (e[u] != 0ull) {
        const uint32_t what = static_cast<uint32_t>(e[u] >> 32);
        const uint32_t rc = static_cast<uint32_t>(e[u]);
        const size_t row = rc >> 2, d = rc & 3u;
        if (what != 1u)   // a new key's claim of its cell
          atomicMax(reinterpret_cast<unsigned int*>(tc + row * 6 + d), what);
        atomicAdd(reinterpret_cast<unsigned int*>(tc + row * 6 + 4 + d / 2),
                  1u << (16 * (d & 1)));
      }
    }
  }
}

// kFam: the table family; kRowUpdate: the row updates the tables
// (row-global headers); kLcp: the row copies prefixes (sorted order; a.lcp
// and a.src are set); kToday: the header's knobs are the ones the JAX
// writer stores today (rough rescue, ctx v2, coarse letters' buckets,
// prefix ramp, two-level mix, no pmer gate, one repair), compile-time
// constants instead of Args values: with them loaded from Args the main
// path's kernel took 127 registers against 119 and 8.5% longer a batch
// (NVIDIA H100 80GB HBM3 at 700 W, PERF.md). kPos: the row's position
// map (kPosNone; kPosSorted, the buckets past the lanes' LCPs; kPosPe,
// read2's coordinates on rowA and rowB), a template parameter for the same
// reason; only rows that copy prefixes or anchors (kLcp) take a map.
template <int kFam, bool kRowUpdate, bool kLcp, bool kToday, int kLoc = 0,
          int kPos = 0>
__global__ void __launch_bounds__(kThreads)
    dna_decode_row_kernel(const Args a) {
  constexpr int kW = row_words<kFam>();
  constexpr bool kLocal = kLoc != kLocNone;
  constexpr bool kDeltas = kLoc == kLocTableDeltas || kLoc == kLocKDeltas;
  static_assert(!kLocal || (!kRowUpdate && !kToday &&
                            (kLoc >= kLocK) == (kFam != kFamTable)),
                "local statistics go with batch-frozen tables, klocal "
                "with canonical ones");
  static_assert(kPos == kPosNone || kLcp,
                "a position map goes with the prefix copy's rows");
  __shared__ fqtz::ScanSmem scan_sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int gw = rank * kWarps + (tid >> 5);     // warp index in the cluster
  const int n_gw = n_blocks * kWarps;
  const int N = static_cast<int>(a.N);
  const int L = static_cast<int>(a.L);
  const int lane = rank * kThreads + tid;
  const bool live = lane < N;

  const int sb = static_cast<int>(a.sb);
  const int siv_len = static_cast<int>(a.siv_len);
  const int smer = static_cast<int>(a.smer_len);
  const int bmer = static_cast<int>(a.bmer_len);
  const int s_w = smer - 1, b_w = bmer - 1;
  const int prefix_len = static_cast<int>(a.prefix_len);
  const int s_lr = static_cast<int>(a.s_log2_rows);
  const int s_lb = static_cast<int>(a.s_log2_base);
  const int b_lr = static_cast<int>(a.b_log2_rows);
  const int b_lb = static_cast<int>(a.b_log2_base);
  const bool mix = kToday || a.mix_w > 0;
  const uint32_t wb = static_cast<uint32_t>(a.mix_w * a.mix_b);
  const uint32_t mix_b = static_cast<uint32_t>(a.mix_b);
  const uint64_t pm_mask = bases_mask(siv_len - 1);
  const uint64_t s_mask = bases_mask(s_w), b_mask = bases_mask(b_w);
  // the header's knobs (uniform over the launch)
  const bool rough = kToday || a.rough != 0;
  const bool ctx_v2 = kToday || a.ctx_v >= 2;
  const bool let_pb2 = kToday || a.let_pb2 != 0;
  const bool ramp = kToday || a.prefix_ramp != 0;
  const int pmer_gate = kToday ? 0 : static_cast<int>(a.pmer_gate);
  const int repair_iters = kToday ? 1 : static_cast<int>(a.repair_iters);
  // _ctx_bits: the code contexts' width, the letters' rows above them
  const int ctx_bits = rough ? 23 : ctx_v2 ? 22 : 20;
  const uint32_t n_model_ctx = (1u << ctx_bits) + (1u << kLetBits);
  const uint32_t coarse_code = rough ? 1u << 10 : 1u << 9;  // N_COARSE_CODE*
  const uint32_t slot_mask = (1u << sb) - 1u;
  const int loc_cells = static_cast<int>(a.local_log2_cells);
  const uint32_t loc_cap = static_cast<uint32_t>(a.local_cap);

  // carried registers
  uint32_t x = kRansL;
  uint64_t pkey = 0, S = 0, B = 0, RS = 0, RB = 0;
  int64_t length = 0, lcp = 0, pos_off = 0, pos_len = 0;
  if (live) {
    const int64_t* rg = a.regs_in + lane;
    x = static_cast<uint32_t>(a.x_in[lane]);
    pkey = static_cast<uint64_t>(rg[0]);
    S = static_cast<uint64_t>(rg[2 * N]) << 32 | static_cast<uint64_t>(rg[N]);
    B = static_cast<uint64_t>(rg[4 * N]) << 32 |
        static_cast<uint64_t>(rg[3 * N]);
    RS = static_cast<uint64_t>(rg[6 * N]) << 32 |
         static_cast<uint64_t>(rg[5 * N]);
    RB = static_cast<uint64_t>(rg[8 * N]) << 32 |
         static_cast<uint64_t>(rg[7 * N]);
    length = a.lengths[lane];
    if (kLcp) lcp = a.lcp[lane];
    if constexpr (kPos != kPosNone) pos_off = a.pos_off[lane];
    if constexpr (kPos == kPosPe) pos_len = a.pos_len[lane];
  }
  const int64_t pos_sign = kPos == kPosPe ? a.pos_sign : 0;
  int64_t ptr = a.ptr_in[0];
  // reset each row
  uint32_t lh = kLhReset, rh = 0, prevc = 0;
  int rep_cnt = 0, srun = 0;
  int parity = 0;
  int64_t* out_base = a.base + static_cast<size_t>(lane) * L;
  int64_t* out_kc = a.kc + static_cast<size_t>(lane) * L;
  int64_t* out_ctx = a.ctx + static_cast<size_t>(lane) * L;
  int64_t* out_sym = a.sym + static_cast<size_t>(lane) * L;
  // one lane a thread: a strided read, L * 8 bytes between lanes
  const int64_t* src_row =
      kLcp ? a.src + static_cast<size_t>(lane) * L : nullptr;
  uint64_t* ev_s = a.events + lane;                     // [L, N] each
  uint64_t* ev_b = a.events + static_cast<size_t>(L) * N + lane;

  cluster.sync();   // every block has started before any remote store
  for (int i = 0; i < L; ++i) {
    const bool active = live && i < length;
    const bool in_prefix = kLcp && active && i < lcp;   // copied
    const bool coded = active && !in_prefix;
    const bool vs = active && i >= s_w;
    const bool vb = active && i >= b_w;
    // what the step's second half reads of the first
    uint32_t counts_g[4], counts[4], sym = 0, ctx_all = 0;
    uint32_t scell[kW] = {}, bcell[kW] = {};
    Query qs = {}, qb = {};
    int level_g = kNone, level = kNone;
    bool use_code = false, take = false;
    if (live) {   // lanes past N only take part in the scan
      const bool vp =
          active && i >= siv_len - 1 && (pmer_gate <= 0 || i < pmer_gate);
      const uint64_t Sm = S & s_mask;
      const uint64_t Bm = B & b_mask;

      // --- finds (their cells also decide the row's insert events) ---
      uint32_t cp[4] = {0, 0, 0, 0}, cs[4] = {0, 0, 0, 0},
               cb[4] = {0, 0, 0, 0};
      bool fp = false, fs = false, fb = false;
      // every load of the step's finds is issued before the first is used
      const uint32_t pword =
          vp ? static_cast<uint32_t>(__ldg(a.siv + (pkey & pm_mask))) : 0u;
      if (vs || vb) {   // a b hit of two or more candidates adds the s counts
        qs = make_query<kFam>(Sm, RS, smer, s_lb, s_lr);
        load_cells<kFam>(a.s_tc, qs.row, scell);
      }
      if (vb) {
        qb = make_query<kFam>(Bm, RB, bmer, b_lb, b_lr);
        load_cells<kFam>(a.b_tc, qb.row, bcell);
      }
      // the local cells of the s and b queries
      constexpr int kLW = kLocal ? local_words<kLoc>() : 1;
      uint32_t lsw[kLW], lbw[kLW];
      LocalKey lsq = {}, lbq = {};
      if constexpr (kLocal) {
        if (vs) {
          lsq = local_key<kLoc>(Sm, RS, smer, loc_cells);
          load_local<kLoc>(a.ls, lsq.cell, lsw);
        }
        if (vb) {
          lbq = local_key<kLoc>(Bm, RB, bmer, loc_cells);
          load_local<kLoc>(a.lb, lbq.cell, lbw);
        }
      }
      // the rough probes' rows (canonical tables), on the guess that the
      // step misses: a miss probes at age srun (the run before it), if
      // that is below s_w
      uint32_t pcell[3][kW];
      Query pq[3];
      if constexpr (kFam != kFamTable) {
        if (rough && vs && srun <= s_w - 1) {
#pragma unroll
          for (uint32_t k = 0; k < 3; ++k) {
            pq[k] =
                rough_query<kFam>(Sm, RS, srun, k, s_w, smer, s_lb, s_lr);
            load_cells<kFam>(a.s_tc, pq[k].row, pcell[k]);
          }
        }
      }
      unpack4(pword, cp);
      fp = (cp[0] + cp[1] + cp[2] + cp[3]) > 0;
      if (vs || vb) fs = row_count<kFam>(scell, qs, cs) && vs;
      if (vb) fb = row_count<kFam>(bcell, qb, cb);

      // --- prefix ramp ---
      if (ramp && active && i >= prefix_len && i < siv_len - 1) {
        const int free = siv_len - 2 - i;
        const uint64_t pfx = pkey & bases_mask(i);
        const uint64_t span = 1ull << (2 * free);
        uint32_t cq[4];
        uint32_t any = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint64_t start = ((pfx << 2) + c) << (2 * free);
          uint64_t tot = 0;
          for (uint64_t t = 0; t < span; ++t) {
            const uint32_t w = static_cast<uint32_t>(__ldg(a.siv + start + t));
            const uint32_t h = (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
            tot += (h & 0xFFFFu) + (h >> 16);
          }
          cq[c] = tot < 255 ? static_cast<uint32_t>(tot) : 255u;
          any += cq[c];
        }
        if (any > 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) cp[c] = cq[c];
          fp = true;
        }
      }

      // --- combine ---
      {
        const int nzb = (cb[0] > 0) + (cb[1] > 0) + (cb[2] > 0) + (cb[3] > 0);
        const bool mixed = fb && nzb > 1;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          counts_g[c] = fb ? cb[c] + (mixed ? cs[c] : 0u)
                           : fs ? cs[c] : fp ? cp[c] : 0u;
        level_g = fb ? (mixed ? kMixed : kBmer)
                     : fs ? kSmer : fp ? kPmer : kNone;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) counts[c] = counts_g[c];
      level = level_g;
      if constexpr (kLocal) {   // the local counts merged (dna._merge_local)
        uint32_t csl[4] = {0, 0, 0, 0}, cbl[4] = {0, 0, 0, 0};
        const bool fsl = vs && local_count<kLoc>(lsw, lsq, csl);
        const bool fbl = vb && local_count<kLoc>(lbw, lbq, cbl);
        const bool fs2 = fs || fsl, fb2 = fb || fbl;
        uint32_t cs2[4], cb2[4];
        int nzb = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cs2[c] = cs[c] + csl[c];
          cb2[c] = cb[c] + cbl[c];
          nzb += cb2[c] > 0 ? 1 : 0;
        }
        const bool mixed = fb2 && nzb > 1;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          counts[c] = fb2 ? cb2[c] + (mixed ? cs2[c] : 0u)
                          : fs2 ? cs2[c] : fp ? cp[c] : 0u;
        level = fb2 ? (mixed ? kMixed : kBmer)
                    : fs2 ? kSmer : fp ? kPmer : kNone;
      }
      if (kFam != kFamTable && rough && i >= s_w) {   // rough rescue
        // (canonical tables only: the rough rescue needs row-global
        // canonical tables, and table rows are never probed)
        const bool miss = vs && !fs && !fb;
        srun = miss ? srun + 1 : 0;
        const int age = srun - 1;
        if (miss && age <= s_w - 1) {
          uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (uint32_t k = 0; k < 3; ++k) {
            uint32_t c4[4];
            row_count<kFam>(pcell[k], pq[k], c4);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] += c4[c];
          }
          uint32_t sum = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[c] = acc[c] < 255u ? acc[c] : 255u;
            sum += acc[c];
          }
          if (sum > 0 && level <= kPmer) {
#pragma unroll
            for (int c = 0; c < 4; ++c) counts[c] = acc[c];
            level = kRsmer;
          }
        }
      }

      // --- context ---
      use_code = level > kNone && i >= prefix_len;
      uint32_t pb;
      if constexpr (kPos != kPosPe) {
        const int64_t rem = length - i;
        pb = i < 24 ? static_cast<uint32_t>(i / 4)
                    : static_cast<uint32_t>(min(6 + (i - 24) / 16, 13));
        if (rem <= 4) pb = 14;
        if (rem <= 2) pb = 15;
      } else {   // read2's coordinate of position i (_pe_pos_map)
        int64_t p = pos_off + pos_sign * i;
        p = p > 0 ? p : 0;
        const int64_t rem = pos_len - p;
        pb = p < 24 ? static_cast<uint32_t>(p / 4)
                    : static_cast<uint32_t>(
                          min(6 + (p - 24) / 16, static_cast<int64_t>(13)));
        if (rem <= 4) pb = 14;
        if (rem <= 2) pb = 15;
      }
      if constexpr (kPos == kPosSorted) {
        // past a shared prefix, the distance from its end
        // (_pos_bucket_sorted)
        if (pos_off > 0) {
          const int64_t rem = length - i;
          const int64_t d = i - pos_off < 13 ? i - pos_off : 13;
          pb = rem <= 2   ? 15u
               : rem <= 4 ? 14u
                          : static_cast<uint32_t>(d > 0 ? d : 0);
        }
      }
      if (use_code) {
        uint32_t v0 = counts[0], v1 = counts[1], v2 = counts[2], v3 = counts[3];
        swap_desc(v0, v1);   // a sorting network, descending
        swap_desc(v2, v3);
        swap_desc(v0, v2);
        swap_desc(v1, v3);
        swap_desc(v1, v2);
        const uint32_t nz = min(static_cast<uint32_t>(__popc(rh)), 4u);
        const uint32_t q = quant0(v0), q1 = quant1(v1), q2 = quant23(v2),
                       q3 = quant23(v3);
        if (rough) {   // a 3-bit level field
          const uint32_t lev = level == kRsmer
                                   ? 4u
                                   : static_cast<uint32_t>(level - 1);
          ctx_all = lev | q << 3 | q1 << 7 | q2 << 10 | q3 << 12 | pb << 14 |
                    nz << 18 | prevc << 21;
        } else {
          ctx_all = static_cast<uint32_t>(level - 1) | q << 2 | q1 << 6 |
                    q2 << 9 | q3 << 11 | pb << 13 | nz << 17 |
                    (ctx_v2 ? prevc << 20 : 0u);
        }
      } else {
        ctx_all = (1u << ctx_bits) +
                  ((lh & kLhMask) | (let_pb2 ? pb >> 2 : pb) << 15);
      }

      // --- cdf: the fine row, mixed with its coarse parent ---
      uint32_t f5[kA], g5[kA] = {0, 0, 0, 0, 0};
      load_row(a.model, ctx_all, f5);
      if constexpr (kDeltas) {   // the fine row's in-batch deltas, clamped
        uint32_t d5[kA];
        load_row(a.lm, ctx_all, d5);
#pragma unroll
        for (int k = 0; k < kA; ++k) f5[k] += d5[k] < loc_cap ? d5[k] : loc_cap;
      }
      uint32_t w_eff = 0, gden = 1;
      if (mix) {
        const uint32_t cctx =
            ctx_all >= (1u << ctx_bits)
                ? coarse_code +
                      ((ctx_all & 0x3Fu) | ((ctx_all >> 15) & 0xFu) << 6)
                : ctx_all & (coarse_code - 1u);
        load_row(a.model, n_model_ctx + cctx, g5);
        uint32_t tf = 0, tg = 0;
#pragma unroll
        for (int k = 0; k < kA; ++k) {
          tf += f5[k];
          tg += g5[k];
        }
        w_eff = wb / (tf + mix_b);
        gden = tg + kA;
      }
      uint32_t cum5[kA];
      uint32_t run = 0;
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        run += f5[k] + (g5[k] * w_eff) / gden + 1u;
        cum5[k] = run;
      }
      const uint32_t total = run;

      // --- decode: lookup, state update ---
      const uint32_t slot = x & slot_mask;
      uint32_t cum = 0, nxt = static_cast<uint32_t>(kA + 1) << 16;
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        const uint32_t bnd = (cum5[k] << sb) / total;
        const bool le = bnd <= slot;
        sym += le ? 1u : 0u;
        cum = le && bnd > cum ? bnd : cum;
        nxt = !le && bnd < nxt ? bnd : nxt;
      }
      const uint32_t f = coded ? nxt - cum : 1u << sb;
      const uint32_t c = coded ? cum : 0u;
      x = f * (x >> sb) + slot - c;
      take = x < kRansL;
    }

    // --- the exclusive scan of the renormalizing lanes, in lane order ---
    const fqtz::TakeScan sc = fqtz::cluster_take_scan(
        cluster, scan_sm, parity, take, gw, n_gw, n_blocks);
    if (take) {
      const int64_t off = ptr + sc.rank;
      const int64_t idx = off < a.n_words - 1 ? off : a.n_words - 1;
      x = x << 16 | static_cast<uint32_t>(__ldg(a.words + idx));
    }
    ptr += sc.total;
    if (!live) continue;

    // --- un-rank, repair, the row's insert events, rolls ---
    uint32_t base;
    if (use_code) {
      if (sym >= 4) {
        base = 4;
      } else {
        int r[4];
        ranks_of(counts, r);
        base = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (r[b] == static_cast<int>(sym)) base = b;
      }
    } else {
      base = sym;
    }
    if (in_prefix) base = static_cast<uint32_t>(src_row[i]);
    if (!active) base = 0;
    uint32_t kc = base >= 4 ? 0u : base;
    {
      // _repair_trigger on the cascade's counts, before the rough rescue
      const uint32_t cbase = base >= 4 ? 0u : counts_g[base];
      uint32_t best = 0, bestc = counts_g[0];
#pragma unroll
      for (int b = 1; b < 4; ++b) {
        if (counts_g[b] > bestc) {
          bestc = counts_g[b];
          best = b;
        }
      }
      const bool trig = level_g >= kSmer && cbase == 0 && bestc >= 2 &&
                        best != kc;
      if (trig && active && rep_cnt < repair_iters) {
        ++rep_cnt;
        kc = best;
      }
    }
    // the event's key is the find's query (the window before i) with kc
    // as its last base: decided now, applied after the row
    if constexpr (kRowUpdate) {
      if (vs)
        ev_s[static_cast<size_t>(i) * N] =
            decide<kFam>(scell, qs.row, tag_word(qs, kc));
      if (vb)
        ev_b[static_cast<size_t>(i) * N] =
            decide<kFam>(bcell, qb.row, tag_word(qb, kc));
    }
    pkey = (pkey << 2 | kc) & pm_mask;
    S = (S << 2 | kc) & s_mask;
    B = (B << 2 | kc) & b_mask;
    const uint64_t comp = 3u - kc;
    RS = RS >> 2 | comp << (2 * (s_w - 1));
    RB = RB >> 2 | comp << (2 * (b_w - 1));
    lh = (lh << 3 | base) & kLhMask;
    const uint32_t rbit = use_code && sym > 0 && coded ? 1u : 0u;
    rh = (rh << 1 | rbit) & 0xFu;
    prevc = use_code ? (level == kRsmer ? 3u : level >= kSmer ? 2u : 1u) : 0u;

    out_base[i] = base;
    out_kc[i] = kc;
    out_ctx[i] = ctx_all;
    out_sym[i] = sym;
  }
  if (live) {
    int64_t* rg = a.regs_out + lane;
    a.x_out[lane] = x;
    rg[0] = static_cast<int64_t>(pkey);
    rg[N] = static_cast<int64_t>(S & 0xFFFFFFFFull);
    rg[2 * N] = static_cast<int64_t>(S >> 32);
    rg[3 * N] = static_cast<int64_t>(B & 0xFFFFFFFFull);
    rg[4 * N] = static_cast<int64_t>(B >> 32);
    rg[5 * N] = static_cast<int64_t>(RS & 0xFFFFFFFFull);
    rg[6 * N] = static_cast<int64_t>(RS >> 32);
    rg[7 * N] = static_cast<int64_t>(RB & 0xFFFFFFFFull);
    rg[8 * N] = static_cast<int64_t>(RB >> 32);
  }
  if (lane == 0) a.ptr_out[0] = ptr;

  // --- the row's s/b table update ---
  // Every lane's finds of this row read the row-start tables; the barrier
  // (release/acquire at cluster scope, and the cluster is the whole grid)
  // puts every one of them before the first write. It also keeps every
  // block resident until no block stores into its shared memory.
  cluster.sync();
  if constexpr (kRowUpdate) {
    if (live) {
      const int end = length < L ? static_cast<int>(length) : L;
      apply_events<kFam>(ev_s, a.s_tc, s_w, end, N);
      apply_events<kFam>(ev_b, a.b_tc, b_w, end, N);
    }
  }
}

// The kernel of one instantiation: (family, row update, lcp, today's
// knobs, local statistics, position map). A context-keyed table never
// takes the row update (row-global context-keyed tables take the row's
// events as torch ops after the launch), only K2 cells with the row update
// take today's knobs, local statistics go with batch-frozen tables
// (local_* with context-keyed ones, klocal_* with canonical ones), and a
// position map with the prefix copy, so the other combinations are not
// instantiated.
using KernelFn = void (*)(Args);
template <int kFam, bool kRowUpdate, bool kToday, int kLoc>
KernelFn lcp_kernel(bool lcp, int pos) {
  if (!lcp)
    return &dna_decode_row_kernel<kFam, kRowUpdate, false, kToday, kLoc>;
  return pos == kPosSorted
             ? &dna_decode_row_kernel<kFam, kRowUpdate, true, kToday, kLoc,
                                      kPosSorted>
         : pos == kPosPe
             ? &dna_decode_row_kernel<kFam, kRowUpdate, true, kToday, kLoc,
                                      kPosPe>
             : &dna_decode_row_kernel<kFam, kRowUpdate, true, kToday, kLoc>;
}

template <int kFam>
KernelFn kernel_of(bool row_update, bool lcp, bool today, int loc, int pos) {
  if constexpr (kFam == kFamTable) {
    return loc == kLocTable ? lcp_kernel<kFam, false, false, kLocTable>(lcp,
                                                                       pos)
           : loc == kLocTableDeltas
               ? lcp_kernel<kFam, false, false, kLocTableDeltas>(lcp, pos)
               : lcp_kernel<kFam, false, false, kLocNone>(lcp, pos);
  } else {
    if (loc != kLocNone)
      return loc == kLocK
                 ? lcp_kernel<kFam, false, false, kLocK>(lcp, pos)
                 : lcp_kernel<kFam, false, false, kLocKDeltas>(lcp, pos);
    if constexpr (kFam == kFamK2) {
      if (row_update && today)
        return lcp_kernel<kFam, true, true, kLocNone>(lcp, pos);
    }
    return row_update ? lcp_kernel<kFam, true, false, kLocNone>(lcp, pos)
                      : lcp_kernel<kFam, false, false, kLocNone>(lcp, pos);
  }
}

}  // namespace

// Launches K2 on `stream` for one read row: `args` holds the kNArgs int64
// values of struct Args in order (pointers as integers). Returns the
// cudaError of the launch (0 = launched).
extern "C" int fqtz_dna_decode_row(const int64_t* args, int n_args,
                                   void* stream) {
  if (n_args != kNArgs) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(&a, args, sizeof(Args));
  const auto s_at = reinterpret_cast<uintptr_t>(a.s_tc);
  const auto b_at = reinterpret_cast<uintptr_t>(a.b_tc);
  // bytes a table row: its u32 words, each held in an int64
  const uint64_t row_bytes = a.family == kFamK2       ? 32
                             : a.family == kFamKtable ? 48
                                                      : 128;
  if (a.N < 1 || a.N > kMaxLanes || a.L < 1 || a.n_words < 1 || a.sb < 1 ||
      a.sb > 16 || a.siv_len < 3 || a.siv_len > 17 || a.smer_len < 3 ||
      a.smer_len > 33 || a.bmer_len < 3 || a.bmer_len > 33 ||
      a.prefix_len < 0 || a.s_log2_base < 1 ||
      a.s_log2_rows < a.s_log2_base || a.s_log2_rows > a.s_log2_base + 4 ||
      a.b_log2_base < 1 || a.b_log2_rows < a.b_log2_base ||
      a.b_log2_rows > a.b_log2_base + 4 || a.s_log2_rows > 30 ||
      a.b_log2_rows > 30 || a.mix_w < 0 || a.mix_w > (1 << 18) ||
      a.mix_b < 1 || a.mix_w * a.mix_b >= (1ll << 31) ||
      a.N * a.L >= (1ll << 31) || (s_at & 15u) != 0 || (b_at & 15u) != 0 ||
      a.events == nullptr || (a.lcp == nullptr) != (a.src == nullptr) ||
      (reinterpret_cast<uintptr_t>(a.events) & 7u) != 0 ||
      a.family < kFamK2 || a.family > kFamTable ||
      (a.family == kFamTable && a.row_update != 0) || a.ctx_v < 1 ||
      a.pmer_gate < 0 || a.repair_iters < 0 || a.repair_iters >= (1 << 20) ||
      (a.rough != 0 && (a.family == kFamTable || a.row_update == 0 ||
                        a.ctx_v < 2)) ||
      a.local < kLocNone || a.local > kLocKDeltas ||
      (a.local != kLocNone &&
       (a.row_update != 0 || a.rough != 0 || a.ls == nullptr ||
        a.lb == nullptr || a.local_log2_cells < 1 ||
        a.local_log2_cells > 30 || a.local_cap < 1 ||
        a.local_cap > (1 << 16) ||
        (a.local >= kLocK) != (a.family != kFamTable) ||
        ((a.local == kLocTableDeltas || a.local == kLocKDeltas) &&
         a.lm == nullptr))) ||
      a.pos < kPosNone || a.pos > kPosPe ||
      (a.pos != kPosNone && (a.lcp == nullptr || a.pos_off == nullptr)) ||
      (a.pos == kPosPe && (a.pos_len == nullptr ||
                           (a.pos_sign != 1 && a.pos_sign != -1))) ||
      (s_at < b_at + (row_bytes << a.b_log2_rows) &&
       b_at < s_at + (row_bytes << a.s_log2_rows)))   // the tables overlap
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = static_cast<int>((a.N + kThreads - 1) / kThreads);
  const bool upd = a.row_update != 0, lcp = a.lcp != nullptr;
  const bool today = a.rough != 0 && a.ctx_v >= 2 && a.let_pb2 != 0 &&
                     a.prefix_ramp != 0 && a.mix_w > 0 && a.pmer_gate == 0 &&
                     a.repair_iters == 1;
  const int loc = static_cast<int>(a.local);
  const int pos = static_cast<int>(a.pos);
  const KernelFn kernel =
      a.family == kFamK2 ? kernel_of<kFamK2>(upd, lcp, today, loc, pos)
      : a.family == kFamKtable
          ? kernel_of<kFamKtable>(upd, lcp, today, loc, pos)
          : kernel_of<kFamTable>(false, lcp, today, loc, pos);
  return static_cast<int>(fqtz::launch_one_cluster(
      kernel, n_blocks, kThreads, static_cast<cudaStream_t>(stream), a));
}
