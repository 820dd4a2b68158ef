// K3: the quality decode scan of one batch — every read row, every
// position, every lane — in one launch.
//
// Replaces the XLA scan of fqsqueezer_tpu/streams/quality.py:
// qual_decode_batch (a lax.scan over read rows around a lax.scan over
// positions; the JAX package has no Pallas kernel on the decode side).
// Same values, step by step for every lane n, position i of row rd:
//   ctx   = hist | pos_bucket(i) << (hist_bits * n_hist)
//   cdf   = floor(cum_k << SB / total) over the model row ctx + ALPHA
//   sym, f, c = cdf_lookup(cdf, x & (2^SB - 1))   (f = 2^SB, c = 0 masked)
//   x     = f * (x >> SB) + slot - c;  renormalize from the shared stream
//   hist  = (hist << hist_bits | sym) & hist_mask  (sym = 0 masked)
// and the lanes that renormalize take consecutive words of ONE stream in
// lane order: an exclusive scan over all N lanes at every step.
//
// Every quality mode runs it: the model row has n_sym = 2 (binary), 4
// (Illumina-4), 8 (Illumina-8) or 96 (lossless) cells, one instantiation
// of the kernel each. With in-batch deltas (QualConfig.with_local, the
// first local-statistics writer's header; kDeltas, one more instantiation
// for each count) the cdf's cells are model + min(lm, cap) + 1, lm the
// batch's delta plane [n_ctx, n_sym] (int32, zeroed by the caller), frozen
// during a read row: at the row's end every lane adds inc at each (ctx,
// sym) of its row with atomicAdd, then the cluster syncs before the next
// row reads the plane (through L2: ld.global.cg). The adds commute, so
// the plane is exact whatever their order; the launch stays one a batch.
//
// What bounds it on an H100: neither bytes nor operations over the card.
// The bytes it must move (the model rows it reads, the words it consumes,
// u8 symbols out) take microseconds at 3.35 TB/s; the time is the chain of
// dependent steps, R / N * L of them a batch: two dependent loads (the
// model row depends on the previous symbol, the word on the scan's
// pointer), one barrier across every lane, and every lane's cdf
// arithmetic. The design keeps each step short:
//  * One lane a thread, 256 threads a block, the lanes spread
//    over ONE thread-block cluster of ceil(N/256) <= 8 blocks on as many
//    SMs, so that eight SMs' schedulers issue the lanes' work (with all
//    2048 lanes in one block, one SM issued them: 4.5 us a step; sixteen
//    blocks of 128 took 1.6% longer than eight of 256: PERF.md).
//  * The scan (cluster_scan.cuh, shared with K2): each warp's ballot
//    total is stored into every block's shared memory, double-buffered by
//    step parity, then ONE cluster barrier a step.
//  * A model row of 2, 4 or 8 cells is one 8-byte, one 16-byte or two
//    16-byte loads: the load unit pays per row a warp touches, and eight
//    4-byte loads took about a third more time a batch than two 16-byte
//    ones. A lossless row (96 cells, 384 B) is walked in 16-byte pieces,
//    twice: once for its total, once for the lookup, which stops at the
//    piece that holds the symbol; no 96-entry array is kept in registers.
//  * The lookup needs no divide a boundary. Boundary k + 1 is
//    floor(run_k << SB / total), run_k the smoothed counts of cells 0..k,
//    and floor(run << SB / total) <= slot exactly when
//    run << SB < (slot + 1) * total: a multiply and a compare. The symbol
//    is the count of boundaries <= slot — the reference's cdf_lookup, so
//    a zero-width step resolves as there — and only its two boundaries
//    take a divide, through one reciprocal of the row total,
//    q' = umulhi(num, floor((2^32-1)/total)), exact after one correction
//    (as K1's divide).
//  * Masked positions read no model row. A read past the stream's end
//    clamps to its last word, as the reference's gather does.
// Preconditions: the model is 16-byte aligned (the wrapper checks), and
// (slot + 1) * total fits 32 bits: models.model_update keeps smoothed row
// totals at most 2^13 + n_sym, and SB <= 16.
// Later work: the model is frozen for the batch, so a wide kernel could
// build every row's cdf once and the scan would read u16 boundaries with
// no divide.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLanes = 2048;      // K3_MAX_LANES in streams/quality.py
constexpr int kThreads = 256;        // lanes a block
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kMaxLanes / kThreads <= 16 &&
                  kMaxLanes / 32 <= fqtz::kScanMaxWarps,
              "a cluster of at most 16 blocks holds every lane");
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t pos_bucket(int i) {
  const int b = i < 8 ? i : 8 + (i - 8) / 24;
  return static_cast<uint32_t>(b < 15 ? b : 15);
}

// floor(num / total) for num < 2^32, from m = floor((2^32 - 1) / total).
__device__ __forceinline__ uint32_t div_by(uint32_t num, uint32_t total,
                                           uint32_t m) {
  uint32_t q = __umulhi(num, m);
  q += (num - q * total) >= total ? 1u : 0u;
  return q;
}

// A 16-byte piece of the delta plane, each cell clamped to cap (read
// through L2: the plane takes the row-end atomics of this launch).
__device__ __forceinline__ uint4 delta_piece(const int32_t* __restrict__ lm,
                                             size_t at, uint32_t cap) {
  const int4 d = __ldcg(reinterpret_cast<const int4*>(lm) + at);
  return make_uint4(min(static_cast<uint32_t>(d.x), cap),
                    min(static_cast<uint32_t>(d.y), cap),
                    min(static_cast<uint32_t>(d.z), cap),
                    min(static_cast<uint32_t>(d.w), cap));
}

// A row's cells, smoothed (+1 each: ALPHA), in one or two wide loads;
// with kDeltas plus the row's clamped deltas.
template <int kSym, bool kDeltas>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ model,
                                         const int32_t* __restrict__ lm,
                                         uint32_t cap, uint32_t ctx,
                                         uint32_t (&v)[kSym]) {
  static_assert(kSym == 2 || kSym == 4 || kSym == 8, "a short row");
  if constexpr (kSym == 2) {
    const int2 a = __ldg(reinterpret_cast<const int2*>(model) + ctx);
    v[0] = a.x; v[1] = a.y;
    if constexpr (kDeltas) {
      const int2 d = __ldcg(reinterpret_cast<const int2*>(lm) + ctx);
      v[0] += min(static_cast<uint32_t>(d.x), cap);
      v[1] += min(static_cast<uint32_t>(d.y), cap);
    }
  } else {
    const int4* row = reinterpret_cast<const int4*>(model) + (kSym / 4) * ctx;
#pragma unroll
    for (int p = 0; p < kSym / 4; ++p) {
      const int4 a = __ldg(row + p);
      v[4 * p] = a.x; v[4 * p + 1] = a.y; v[4 * p + 2] = a.z;
      v[4 * p + 3] = a.w;
      if constexpr (kDeltas) {
        const uint4 d =
            delta_piece(lm, static_cast<size_t>(kSym / 4) * ctx + p, cap);
        v[4 * p] += d.x; v[4 * p + 1] += d.y; v[4 * p + 2] += d.z;
        v[4 * p + 3] += d.w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSym; ++k) v[k] += 1u;
}

// One cell of the lookup: run takes the cell's smoothed count; while the
// boundary after it is <= slot, the symbol counts it and lo moves to it,
// and the first boundary above the slot is hi.
__device__ __forceinline__ void look(uint32_t cell, uint32_t lim, int sb,
                                     uint32_t& run, uint32_t& sym,
                                     uint32_t& lo, uint32_t& hi) {
  run += cell;
  const bool le = (run << sb) < lim;
  sym += le ? 1u : 0u;
  lo = le ? run : lo;
  hi = !le && run < hi ? run : hi;
}

// One lane's symbol lookup and state update before renormalization.
// Returns the symbol (0 when masked); x becomes the pre-renorm state.
template <int kSym, bool kDeltas>
__device__ __forceinline__ uint32_t lane_step(
    const int32_t* __restrict__ model, const int32_t* __restrict__ lm,
    uint32_t cap, uint32_t ctx, bool active, uint32_t& x, int sb) {
  const uint32_t slot = x & ((1u << sb) - 1u);
  uint32_t f = 1u << sb, c = 0, sym = 0;
  if (active) {
    uint32_t total = 0, run = 0, lo = 0, hi;
    if constexpr (kSym <= 8) {
      uint32_t v[kSym];
      load_row<kSym, kDeltas>(model, lm, cap, ctx, v);
#pragma unroll
      for (int k = 0; k < kSym; ++k) total += v[k];
      const uint32_t lim = (slot + 1u) * total;
      hi = total;
#pragma unroll
      for (int k = 0; k < kSym; ++k) look(v[k], lim, sb, run, sym, lo, hi);
    } else {
      static_assert(kSym % 4 == 0, "a long row is walked in 16-byte pieces");
      const int4* row = reinterpret_cast<const int4*>(model) + (kSym / 4) * ctx;
      const size_t at = static_cast<size_t>(kSym / 4) * ctx;
      // one 16-byte piece of the row, smoothed (and with its deltas)
      const auto piece = [&](int p) {
        const int4 a = __ldg(row + p);
        uint4 c = make_uint4(static_cast<uint32_t>(a.x) + 1u,
                             static_cast<uint32_t>(a.y) + 1u,
                             static_cast<uint32_t>(a.z) + 1u,
                             static_cast<uint32_t>(a.w) + 1u);
        if constexpr (kDeltas) {
          const uint4 d = delta_piece(lm, at + p, cap);
          c.x += d.x; c.y += d.y; c.z += d.z; c.w += d.w;
        }
        return c;
      };
      if constexpr (kDeltas) {
        // the pieces' sums stay in registers: the lookup skips the pieces
        // wholly below the slot without loading them again, and reloads
        // only the piece that holds the symbol (a walk reloading every
        // piece waited on one L2 read of the deltas a piece)
        uint32_t ps[kSym / 4];
#pragma unroll
        for (int p = 0; p < kSym / 4; ++p) {
          const uint4 c = piece(p);
          ps[p] = c.x + c.y + c.z + c.w;
          total += ps[p];
        }
        const uint32_t lim = (slot + 1u) * total;
        hi = total;
        // run << sb < lim at a piece's end: its every boundary is <= slot
        // (the last piece's end, total << sb, never is)
        int q = 0;
#pragma unroll
        for (int p = 0; p < kSym / 4; ++p) {
          const bool below = q == p && ((run + ps[p]) << sb) < lim;
          run += below ? ps[p] : 0u;
          q += below ? 1 : 0;
        }
        sym = 4u * static_cast<uint32_t>(q);
        lo = run;
        const uint4 c = piece(q);
        look(c.x, lim, sb, run, sym, lo, hi);
        look(c.y, lim, sb, run, sym, lo, hi);
        look(c.z, lim, sb, run, sym, lo, hi);
        look(c.w, lim, sb, run, sym, lo, hi);
      } else {
#pragma unroll 4
        for (int p = 0; p < kSym / 4; ++p) {
          const uint4 c = piece(p);
          total += c.x + c.y + c.z + c.w;
        }
        const uint32_t lim = (slot + 1u) * total;
        hi = total;
        // the last boundary (run = total) is above every slot, so the walk
        // ends at the piece where hi first moves
        for (int p = 0; p < kSym / 4 && hi == total; ++p) {
          const uint4 c = piece(p);
          look(c.x, lim, sb, run, sym, lo, hi);
          look(c.y, lim, sb, run, sym, lo, hi);
          look(c.z, lim, sb, run, sym, lo, hi);
          look(c.w, lim, sb, run, sym, lo, hi);
        }
      }
    }
    const uint32_t m = kFull / total;
    c = div_by(lo << sb, total, m);
    f = div_by(hi << sb, total, m) - c;
  }
  x = f * (x >> sb) + slot - c;
  return active ? sym : 0u;
}

template <int kSym, bool kDeltas>
__global__ void __launch_bounds__(kThreads)
    qual_decode_kernel(const int32_t* __restrict__ model, int hist_bits,
                       int n_hist,
                       const int32_t* __restrict__ lengths, int r_pl, int L,
                       const int32_t* __restrict__ words, int n_words,
                       const int64_t* __restrict__ init, int N, int sb,
                       uint8_t* __restrict__ syms, int64_t* __restrict__ fin,
                       int64_t* __restrict__ ptr_out, int32_t* lm,
                       uint32_t cap, int inc) {
  __shared__ fqtz::ScanSmem scan_sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int gw = rank * kWarps + (tid >> 5);     // warp index in the cluster
  const int n_gw = n_blocks * kWarps;
  const int pos_shift = hist_bits * n_hist;
  const uint32_t hist_mask = (1u << pos_shift) - 1u;
  const int lane = rank * kThreads + tid;
  const bool live = lane < N;

  uint32_t x = live ? static_cast<uint32_t>(init[lane]) : kRansL;
  int ptr = 0;
  int parity = 0;
  cluster.sync();   // every block has started before any remote store
  for (int rd = 0; rd < r_pl; ++rd) {
    const size_t read = static_cast<size_t>(lane) * r_pl + rd;
    const int len = live ? lengths[read] : 0;
    uint32_t hist = hist_mask;
    uint8_t* out = syms + read * L;
    for (int i = 0; i < L; ++i) {
      const uint32_t sym = lane_step<kSym, kDeltas>(
          model, lm, cap, hist | pos_bucket(i) << pos_shift, i < len, x, sb);
      const bool take = live && x < kRansL;
      // exclusive scan of the renormalizing lanes, in lane order
      const fqtz::TakeScan sc = fqtz::cluster_take_scan(
          cluster, scan_sm, parity, take, gw, n_gw, n_blocks);
      if (take) {
        const int off = ptr + sc.rank;
        const int at = off < n_words ? off : n_words - 1;
        x = (x << 16) | static_cast<uint32_t>(__ldg(words + at));
      }
      if (live) {
        out[i] = static_cast<uint8_t>(sym);
        hist = ((hist << hist_bits) | sym) & hist_mask;
      }
      ptr += sc.total;
    }
    if constexpr (kDeltas) {
      // the row's (ctx, sym) events into the delta plane; the barrier
      // puts every lane's adds before the next row's reads
      if (live) {
        uint32_t h = hist_mask;
        for (int i = 0; i < len; ++i) {
          const uint32_t sym = out[i];
          const uint32_t ctx = h | pos_bucket(i) << pos_shift;
          atomicAdd(lm + static_cast<size_t>(ctx) * kSym + sym, inc);
          h = ((h << hist_bits) | sym) & hist_mask;
        }
      }
      cluster.sync();
    }
  }
  if (live) fin[lane] = static_cast<int64_t>(x);
  if (lane == 0) ptr_out[0] = ptr;
  cluster.sync();   // no block leaves while another may store into it
}

}  // namespace

// Launches K3 on `stream` for one batch of R = N * r_pl reads: model int32
// [n_ctx, A] (16-byte aligned; A = 2, 4, 8 or 96 cells a row), lengths
// int32 [R] (read r = lane * r_pl + row), words int32 [n_words] (u16
// values), init int64 [N] (u32 states); writes syms u8 [R, L], fin int64
// [N] and ptr_out int64 [1] (words consumed). lm: null, or the batch's
// in-batch delta plane int32 [n_ctx, A] (16-byte aligned, zeroed), updated
// in place, with the deltas' cap (models.local_cap) and
// their increment. Returns the cudaError of the launch (0 = launched).
extern "C" int fqtz_qual_decode(const void* model, int A, int hist_bits,
                                int n_hist, const void* lengths, int r_pl,
                                int L, const void* words, int n_words,
                                const void* init, int N, int sb, void* syms,
                                void* fin, void* ptr_out, void* lm, int cap,
                                int inc, void* stream) {
  if (N < 1 || N > kMaxLanes || sb < 1 || sb > 16 || n_words < 1 ||
      r_pl < 0 || L < 0 || hist_bits < 1 || n_hist < 1 ||
      hist_bits * n_hist > 26 ||
      (reinterpret_cast<uintptr_t>(model) & 15u) != 0 ||
      (lm != nullptr && ((reinterpret_cast<uintptr_t>(lm) & 15u) != 0 ||
                         cap < 1 || cap > (1 << 16) || inc < 0 ||
                         inc > (1 << 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (N + kThreads - 1) / kThreads;
  const auto launch = [&](auto kernel) {
    return static_cast<int>(fqtz::launch_one_cluster(
        kernel, n_blocks, kThreads, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(model), hist_bits, n_hist,
        static_cast<const int32_t*>(lengths), r_pl, L,
        static_cast<const int32_t*>(words), n_words,
        static_cast<const int64_t*>(init), N, sb,
        static_cast<uint8_t*>(syms), static_cast<int64_t*>(fin),
        static_cast<int64_t*>(ptr_out), static_cast<int32_t*>(lm),
        static_cast<uint32_t>(cap), inc));
  };
  if (lm != nullptr) {
    switch (A) {
      case 2: return launch(qual_decode_kernel<2, true>);
      case 4: return launch(qual_decode_kernel<4, true>);
      case 8: return launch(qual_decode_kernel<8, true>);
      case 96: return launch(qual_decode_kernel<96, true>);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (A) {   // K3_SYM in streams/quality.py
    case 2: return launch(qual_decode_kernel<2, false>);
    case 4: return launch(qual_decode_kernel<4, false>);
    case 8: return launch(qual_decode_kernel<8, false>);
    case 96: return launch(qual_decode_kernel<96, false>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
