// K2: one read row of the DNA decode scan — every position, every lane —
// in one launch.
//
// Replaces the XLA scan of fqsqueezer_tpu/streams/dna.py: dna_decode_batch
// (its `outer` scan over read rows around the `inner` step over positions;
// the JAX package has no Pallas kernel on the decode side). Its plain
// version is streams/dna.py:dna_decode_row_plain, step for step, for the
// header the JAX writer stores (dna.check_supported: ctx v2, rough rescue,
// let_pb2, two-level mix, prefix ramp, no pmer gate, one repair). For lane
// n at position i of the row:
//   finds    SIV word of pkey; the canonical s and b queries (canon strand,
//            hash bucket and tag, 4 end-letter slots) into the K2 tables,
//            one 32-byte row each, the bucket widened by the tag's growth
//            bits when the table has grown
//   ramp     at prefix_len <= i < siv_len-1 the SIV ranges of the decoded
//            prefix replace the SIV counts (SWAR byte folds)
//   combine  the cascade (b, mixed, s, SIV); at i >= s_w the rough rescue:
//            srun counts s/b misses, 3 single-base substitutions of the s
//            window at the suspect offset, one s find each
//   context  sorted counts quantized, position bucket, rank-miss history,
//            previous level class; or the letters context
//   cdf      fine row ctx and coarse row mixed: w_eff = w*b/(tf+b), cells
//            f + g*w_eff/(tg+A) + 1, boundaries (cum << SB) / total
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
//   repair   on the cascade's counts from before the rough rescue, at most
//            once a row; then the rolls of pkey, the s/b windows, their
//            reverse complements, the letters and rank histories
//   out      base, eff (kc), ctx and sym of position i, int64 [N, L]
//   events   at i >= k - 1 (k = smer_len, then bmer_len) and i < length:
//            the row's canonical s-mer and b-mer insert event, whose key is
//            the find's own query with the decoded kc as its candidate;
//            its tables.k2_update decision (cell index, new word) is taken
//            from the cells the find loaded
// and after the row's last position, the row's s/b table update (the end
// of the reference's `outer` step, _apply_sb_updates): every decision was
// taken against the row-start tables, one cluster barrier follows the
// scan, and then every lane max-es its decisions into the tables with
// 64-bit atomics, in place. That is k2_update's one gather and one
// scatter-max: duplicate events of one key raise its count once, new keys
// that pick one empty slot leave the larger word, a new key whose
// row-start bucket is full is dropped, counts saturate at 255.
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
//  * Tables are read in place: a K2 row as two 16-byte loads, the SIV word
//    and the model's 20-byte rows as 4-byte loads. Masked lanes read no
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
// other values are what the codec stores): K2 cells, SIV words, states and window registers are u32
// values (the registers masked to their windows); model rows are
// model_update's, smoothed totals at most 2^13, so with w*b < 2^31 and
// w <= 2^18 every product and boundary of the cdf fits 32 bits; the s and
// b tables do not overlap (they are updated in place).
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
constexpr int kCtxBits = 23;         // CODE_CTX_BITS_ROUGH
constexpr int kLetBits = 19;         // LET_CTX_BITS
constexpr uint32_t kCoarseCode = 1u << 10;   // N_COARSE_CODE_ROUGH

// The launch's arguments, in the order of K2_ARGS in streams/dna.py.
struct Args {
  const int64_t* siv;       // [4^(siv_len-1)] u32 words
  int64_t* s_tc;            // [2^s_log2_rows, 4] u32 cells, updated in place
  int64_t* b_tc;            // [2^b_log2_rows, 4]
  const int32_t* model;     // [n_model_ctx + n_coarse_ctx, 5]
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
};
constexpr int kNArgs = sizeof(Args) / sizeof(int64_t);
static_assert(sizeof(void*) == sizeof(int64_t), "64-bit pointers");
// regs rows: pkey, slo, shi, blo, bhi, rslo, rshi, rblo, rbhi (u32 halves)
constexpr int kRepairIters = 1;   // the header's dna_repair_iters

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

// A canonical 4-candidate query of a width-k table: its (grown) bucket row
// and each candidate's cell tag word (tables.k2tag << 8).
struct Query {
  uint32_t row;
  uint32_t tw[4];
};

// c: the (k-1)-base context window, r: its reverse complement.
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
    q.tw[b] = twb | slot << 8;
  }
  return q;
}

// One bucket row of a K2 table: two 16-byte loads, the four u32 cells.
__device__ __forceinline__ void load_cells(const int64_t* tc, uint32_t row,
                                           uint32_t cell[4]) {
  const longlong2* p = reinterpret_cast<const longlong2*>(tc) +
                       2 * static_cast<size_t>(row);
  const longlong2 a = __ldg(p);
  const longlong2 b = __ldg(p + 1);
  cell[0] = static_cast<uint32_t>(a.x);
  cell[1] = static_cast<uint32_t>(a.y);
  cell[2] = static_cast<uint32_t>(b.x);
  cell[3] = static_cast<uint32_t>(b.y);
}

// tables.k2_find on a loaded row: the 4 candidates' summed counts over the
// row's matching cells; returns whether any cell matched.
__device__ __forceinline__ bool k2_count(const uint32_t cell[4],
                                         const Query& q, uint32_t cnt[4]) {
  bool found = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cnt[c] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((cell[j] & 0xFFFFFF00u) == q.tw[c]) {
        cnt[c] += cell[j] & 0xFFu;
        found = true;
      }
    }
  }
  return found;
}

// The query of rough probe k (0..2): the s window Sm (its reverse
// complement RS) with the base at offset `age` replaced by the k-th of the
// three others.
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
  return canon_query(Sj, Rj, smer, lb, lr);
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
// atomics (a decision of 0 is a dropped event).
__device__ __forceinline__ void apply_events(const uint64_t* ev,
                                             unsigned long long* cells,
                                             int from, int end, int N) {
  for (int i0 = from; i0 < end; i0 += kEventBatch) {
    uint64_t e[kEventBatch];
#pragma unroll
    for (int u = 0; u < kEventBatch; ++u)
      e[u] = i0 + u < end ? ev[static_cast<size_t>(i0 + u) * N] : 0ull;
#pragma unroll
    for (int u = 0; u < kEventBatch; ++u)
      if (static_cast<uint32_t>(e[u]) != 0u)
        atomicMax(cells + (e[u] >> 32), e[u] & 0xFFFFFFFFull);
  }
}

// kLcp: the row copies prefixes (sorted order; a.lcp and a.src are set).
template <bool kLcp>
__global__ void __launch_bounds__(kThreads)
    dna_decode_row_kernel(const Args a) {
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
  const uint32_t wb = static_cast<uint32_t>(a.mix_w * a.mix_b);
  const uint32_t mix_b = static_cast<uint32_t>(a.mix_b);
  const uint64_t pm_mask = bases_mask(siv_len - 1);
  const uint64_t s_mask = bases_mask(s_w), b_mask = bases_mask(b_w);
  const uint32_t n_model_ctx = (1u << kCtxBits) + (1u << kLetBits);
  const uint32_t slot_mask = (1u << sb) - 1u;

  // carried registers
  uint32_t x = kRansL;
  uint64_t pkey = 0, S = 0, B = 0, RS = 0, RB = 0;
  int64_t length = 0, lcp = 0;
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
  }
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
    uint32_t scell[4] = {0, 0, 0, 0}, bcell[4] = {0, 0, 0, 0};
    Query qs = {}, qb = {};
    int level_g = kNone, level = kNone;
    bool use_code = false, take = false;
    if (live) {   // lanes past N only take part in the scan
      const bool vp = active && i >= siv_len - 1;
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
        qs = canon_query(Sm, RS, smer, s_lb, s_lr);
        load_cells(a.s_tc, qs.row, scell);
      }
      if (vb) {
        qb = canon_query(Bm, RB, bmer, b_lb, b_lr);
        load_cells(a.b_tc, qb.row, bcell);
      }
      // the rough probes' rows, on the guess that the step misses: a miss
      // probes at age srun (the run before it), if that is below s_w
      uint32_t pcell[3][4];
      Query pq[3];
      if (vs && srun <= s_w - 1) {
#pragma unroll
        for (uint32_t k = 0; k < 3; ++k) {
          pq[k] = rough_query(Sm, RS, srun, k, s_w, smer, s_lb, s_lr);
          load_cells(a.s_tc, pq[k].row, pcell[k]);
        }
      }
      unpack4(pword, cp);
      fp = (cp[0] + cp[1] + cp[2] + cp[3]) > 0;
      if (vs || vb) fs = k2_count(scell, qs, cs) && vs;
      if (vb) fb = k2_count(bcell, qb, cb);

      // --- prefix ramp ---
      if (active && i >= prefix_len && i < siv_len - 1) {
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
      if (i >= s_w) {   // rough rescue
        const bool miss = vs && !fs && !fb;
        srun = miss ? srun + 1 : 0;
        const int age = srun - 1;
        if (miss && age <= s_w - 1) {
          uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (uint32_t k = 0; k < 3; ++k) {
            uint32_t c4[4];
            k2_count(pcell[k], pq[k], c4);
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
      {
        const int64_t rem = length - i;
        pb = i < 24 ? static_cast<uint32_t>(i / 4)
                    : static_cast<uint32_t>(min(6 + (i - 24) / 16, 13));
        if (rem <= 4) pb = 14;
        if (rem <= 2) pb = 15;
      }
      if (use_code) {
        uint32_t v0 = counts[0], v1 = counts[1], v2 = counts[2], v3 = counts[3];
        swap_desc(v0, v1);   // a sorting network, descending
        swap_desc(v2, v3);
        swap_desc(v0, v2);
        swap_desc(v1, v3);
        swap_desc(v1, v2);
        const uint32_t lev = level == kRsmer ? 4u
                                             : static_cast<uint32_t>(level - 1);
        const uint32_t nz = min(static_cast<uint32_t>(__popc(rh)), 4u);
        ctx_all = lev | quant0(v0) << 3 | quant1(v1) << 7 | quant23(v2) << 10 |
                  quant23(v3) << 12 | pb << 14 | nz << 18 | prevc << 21;
      } else {
        ctx_all = (1u << kCtxBits) + ((lh & kLhMask) | (pb >> 2) << 15);
      }

      // --- cdf: the fine row mixed with its coarse parent ---
      const uint32_t cctx =
          ctx_all >= (1u << kCtxBits)
              ? kCoarseCode + ((ctx_all & 0x3Fu) | ((ctx_all >> 15) & 0xFu) << 6)
              : ctx_all & 0x3FFu;
      uint32_t f5[kA], g5[kA];
      load_row(a.model, ctx_all, f5);
      load_row(a.model, n_model_ctx + cctx, g5);
      uint32_t tf = 0, tg = 0;
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        tf += f5[k];
        tg += g5[k];
      }
      const uint32_t w_eff = wb / (tf + mix_b);
      const uint32_t gden = tg + kA;
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
      if (trig && active && rep_cnt < kRepairIters) {
        ++rep_cnt;
        kc = best;
      }
    }
    // the event's key is the find's query (the window before i) with kc
    // as its last base: decided now, applied after the row
    if (vs)
      ev_s[static_cast<size_t>(i) * N] =
          k2_decide(scell, qs.row, tag_word(qs, kc));
    if (vb)
      ev_b[static_cast<size_t>(i) * N] =
          k2_decide(bcell, qb.row, tag_word(qb, kc));
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
  if (live) {
    const int end = length < L ? static_cast<int>(length) : L;
    unsigned long long* s_cells =
        reinterpret_cast<unsigned long long*>(a.s_tc);
    unsigned long long* b_cells =
        reinterpret_cast<unsigned long long*>(a.b_tc);
    apply_events(ev_s, s_cells, s_w, end, N);
    apply_events(ev_b, b_cells, b_w, end, N);
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
  if (a.N < 1 || a.N > kMaxLanes || a.L < 1 || a.n_words < 1 || a.sb < 1 ||
      a.sb > 16 || a.siv_len < 3 || a.siv_len > 17 || a.smer_len < 3 ||
      a.smer_len > 33 || a.bmer_len < 3 || a.bmer_len > 33 ||
      a.prefix_len < 0 || a.s_log2_base < 1 ||
      a.s_log2_rows < a.s_log2_base || a.s_log2_rows > a.s_log2_base + 4 ||
      a.b_log2_base < 1 || a.b_log2_rows < a.b_log2_base ||
      a.b_log2_rows > a.b_log2_base + 4 || a.s_log2_rows > 30 ||
      a.b_log2_rows > 30 || a.mix_w < 1 || a.mix_w > (1 << 18) ||
      a.mix_b < 1 || a.mix_w * a.mix_b >= (1ll << 31) ||
      a.N * a.L >= (1ll << 31) || (s_at & 15u) != 0 || (b_at & 15u) != 0 ||
      a.events == nullptr || (a.lcp == nullptr) != (a.src == nullptr) ||
      (reinterpret_cast<uintptr_t>(a.events) & 7u) != 0 ||
      (s_at < b_at + (32ull << a.b_log2_rows) &&
       b_at < s_at + (32ull << a.s_log2_rows)))   // the tables overlap
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = static_cast<int>((a.N + kThreads - 1) / kThreads);
  void (*kernel)(Args) = a.lcp != nullptr ? &dna_decode_row_kernel<true>
                                           : &dna_decode_row_kernel<false>;
  return static_cast<int>(fqtz::launch_one_cluster(
      kernel, n_blocks, kThreads, static_cast<cudaStream_t>(stream), a));
}
