// K4 and K5: the id decode scan and the meta decode scan of one batch —
// every read row, every symbol slot, every lane — each in one launch.
//
// Replace the XLA scans of the JAX package (no Pallas kernel there):
//   K4  fqsqueezer_tpu/streams/ids.py: id_decode_batch (its lax.scan over
//       r_pl * w_all slot steps), codecs v1 and v2;
//   K5  fqsqueezer_tpu/streams/meta.py: meta_decode_batch (its lax.scan
//       over W * r_pl steps; W = 2, or 3 with the LCP).
// Same values, step by step for every lane n, slot i of read row rd:
//   active = the slot's rule (below) and, with a padding bound (id codec
//            v2), read = n * r_pl + rd < n_valid
//   sym, f, c = cdf_lookup(the slot's cdf row, x & (2^SB - 1))
//               (f = 2^SB, c = 0, sym = 0 when inactive)
//   x      = f * (x >> SB) + slot - c;  renormalize from the shared stream
// and the lanes that renormalize take consecutive words of ONE stream in
// lane order: an exclusive scan over all N lanes at every step.
//
// A slot's cdf row is the same for every lane: the model is frozen for the
// batch and a slot's context is static (ids._slot_ctx; meta: context =
// slot). So the caller builds the rows once a batch as a table of u32
// boundaries — K4: every context's, int32 [79, 257] (ids._ctx_cdfs:
// model_cdf_masked under v2, model_cdf under v1); K5: int32 [W, 257]
// (meta.meta_cdfs) — and each block stages the whole table into its shared
// memory once a launch (K4's 81,212 bytes through the dynamic shared
// memory opt-in). The table stays u32 rather than u16: at SB = 16 the
// boundaries reach 2^16, and a zero-width last symbol (a v2 flag row)
// puts 2^16 inside the row, not only at its implied end.
//
// The id rule (K4): a slot word ctx | kind << 8 | arg << 12 a slot
// (ids.k4_slots) and the lane's carries in registers — the flag, the F <=
// 12 delta symbols (4 bits each in one u64, clamped to 8 as the
// reference's clamped gather of _NB_LUT reads them) and the escape length:
//   flag          every lane
//   delta f       flag == 0
//   magnitude f,j flag == 0 and NB_LUT[delta f] > j
//   len lo, hi    flag > 0
//   byte col      flag > 0 and len > col
// then flag, delta f, len = sym, and at len hi len = min(len | sym << 8, M)
// (the reference's step, fqsqueezer_tpu/streams/ids.py:647-698). The meta
// rule (K5): every slot active, row = slot.
//
// The lookup: the symbol is the count of boundaries 1..256 at or below the
// slot; on a non-decreasing row that is the largest k with row[k] <= slot,
// found by an 8-probe binary search over the staged row (row[0] = 0 <= slot
// < 2^SB = row[256]), then c = row[k] and f = row[k + 1] - c: the
// reference's masked reductions (rans.cdf_lookup), zero-width steps
// included — a v2 flag or delta row has up to 254 or 247 of them.
//
// What bounds it on an H100: neither bytes nor operations over the card
// (the table, the words consumed and the u8 symbols take microseconds at
// 3.35 TB/s); the time is the chain of R / N * W dependent steps, each a
// binary search in shared memory, the state update and one cluster barrier
// for the word scan. The layout is K3's (csrc/qual_decode.cu): one lane a
// thread, 256 threads a block, ceil(N / 256) <= 8 blocks in ONE
// thread-block cluster, the scan through cluster_scan.cuh. A read past the
// stream's end clamps to its last word, as the reference's gather does.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLanes = 2048;      // K4_MAX_LANES, K5_MAX_LANES
constexpr int kThreads = 256;        // lanes a block
constexpr int kWarps = kThreads / 32;
static_assert(kMaxLanes / kThreads <= fqtz::kPortableCluster &&
                  kMaxLanes / 32 <= fqtz::kScanMaxWarps,
              "a portable cluster holds every lane");
constexpr int kCdf = 257;            // boundaries a row: 256 symbols + 1
constexpr int kIdRows = 79;          // ids.N_CTX
constexpr int kMaxMetaRows = 3;      // meta.N_CTX
constexpr uint32_t kRansL = 1u << 16;

// slot kinds of the id rule (ids.SLOT_*)
constexpr uint32_t kFlag = 0, kDelta = 1, kMag = 2, kLen0 = 3, kLen1 = 4,
                   kByte = 5;

enum Rule { kMeta = 0, kIds = 1 };

// _NB_LUT: magnitude bytes of a delta symbol (0..8)
__device__ __forceinline__ uint32_t nb_of(uint32_t ds) {
  return ds < 3u ? 0u : 1u << ((ds - 3u) >> 1);
}

template <int kRule>
__global__ void __launch_bounds__(kThreads)
    slot_decode_kernel(const int32_t* __restrict__ table, int n_rows,
                       const int32_t* __restrict__ slots, int W, int r_pl,
                       const int32_t* __restrict__ words, int n_words,
                       const int64_t* __restrict__ init, int N, int sb,
                       int n_valid, int M, uint8_t* __restrict__ out,
                       int64_t* __restrict__ fin,
                       int64_t* __restrict__ ptr_out) {
  extern __shared__ int32_t cdf_sm[];   // the table, [n_rows, 257]
  __shared__ fqtz::ScanSmem scan_sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int gw = rank * kWarps + (tid >> 5);     // warp index in the cluster
  const int n_gw = n_blocks * kWarps;
  const int lane = rank * kThreads + tid;
  const bool live = lane < N;
  const uint32_t slot_mask = (1u << sb) - 1u;

  for (int k = tid; k < n_rows * kCdf; k += kThreads)
    cdf_sm[k] = __ldg(table + k);
  uint32_t x = live ? static_cast<uint32_t>(init[lane]) : kRansL;
  int ptr = 0;
  int parity = 0;
  uint32_t flag = 0, len = 0;   // the id rule's carries
  uint64_t ds = 0;
  __syncthreads();
  cluster.sync();   // every block has started before any remote store
  for (int rd = 0; rd < r_pl; ++rd) {
    const int read = lane * r_pl + rd;
    const bool valid = live && read < n_valid;
    uint8_t* row_out = out + static_cast<size_t>(read) * W;
    for (int i = 0; i < W; ++i) {
      uint32_t ctx = static_cast<uint32_t>(i), kind = 0, arg = 0;
      bool active = valid;
      if constexpr (kRule == kIds) {
        const uint32_t s = static_cast<uint32_t>(__ldg(slots + i));
        ctx = s & 0xFFu;
        kind = (s >> 8) & 0xFu;
        arg = s >> 12;
        switch (kind) {
          case kFlag: break;
          case kDelta: active = active && flag == 0u; break;
          case kMag:
            active = active && flag == 0u &&
                     nb_of(static_cast<uint32_t>(ds >> (4u * (arg >> 2))) &
                           0xFu) > (arg & 3u);
            break;
          case kLen0:
          case kLen1: active = active && flag > 0u; break;
          default: active = active && flag > 0u && len > arg; break;
        }
      }
      const uint32_t slot = x & slot_mask;
      uint32_t f = 1u << sb, c = 0, sym = 0;
      if (active) {
        const int32_t* row = cdf_sm + ctx * kCdf;
        uint32_t k = 0;
#pragma unroll
        for (uint32_t h = 128; h >= 1; h >>= 1)
          k = static_cast<uint32_t>(row[k + h]) <= slot ? k + h : k;
        sym = k;
        c = static_cast<uint32_t>(row[k]);
        f = static_cast<uint32_t>(row[k + 1]) - c;
      }
      x = f * (x >> sb) + slot - c;
      if constexpr (kRule == kIds) {
        if (kind == kFlag) {
          flag = sym;
        } else if (kind == kDelta) {
          const uint32_t sh = 4u * arg;
          ds = (ds & ~(uint64_t{0xF} << sh)) |
               (static_cast<uint64_t>(sym < 8u ? sym : 8u) << sh);
        } else if (kind == kLen0) {
          len = sym;
        } else if (kind == kLen1) {
          const uint32_t v = len | sym << 8;
          len = v < static_cast<uint32_t>(M) ? v : static_cast<uint32_t>(M);
        }
      }
      const bool take = live && x < kRansL;
      // exclusive scan of the renormalizing lanes, in lane order
      const fqtz::TakeScan sc = fqtz::cluster_take_scan(
          cluster, scan_sm, parity, take, gw, n_gw, n_blocks);
      if (take) {
        const int off = ptr + sc.rank;
        const int at = off < n_words ? off : n_words - 1;
        x = (x << 16) | static_cast<uint32_t>(__ldg(words + at));
      }
      if (live) row_out[i] = static_cast<uint8_t>(sym);
      ptr += sc.total;
    }
  }
  if (live) fin[lane] = static_cast<int64_t>(x);
  if (lane == 0) ptr_out[0] = ptr;
  cluster.sync();   // no block leaves while another may store into it
}

template <int kRule>
int launch(const void* table, int n_rows, const void* slots, int W,
           int r_pl, const void* words, int n_words, const void* init, int N,
           int sb, int n_valid, int M, void* out, void* fin, void* ptr_out,
           void* stream) {
  if (N < 1 || N > kMaxLanes || sb < 1 || sb > 16 || n_words < 1 ||
      r_pl < 0 || W < 0 || M < 0 ||
      static_cast<int64_t>(N) * r_pl * (W > 0 ? W : 1) >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (N + kThreads - 1) / kThreads;
  return static_cast<int>(fqtz::launch_one_cluster_smem(
      slot_decode_kernel<kRule>, n_blocks, kThreads,
      static_cast<size_t>(n_rows) * kCdf * sizeof(int32_t),
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(table),
      n_rows, static_cast<const int32_t*>(slots), W, r_pl,
      static_cast<const int32_t*>(words), n_words,
      static_cast<const int64_t*>(init), N, sb, n_valid, M,
      static_cast<uint8_t*>(out), static_cast<int64_t*>(fin),
      static_cast<int64_t*>(ptr_out)));
}

}  // namespace

// Launches K4 on `stream` for one batch of R = N * r_pl reads of W slots:
// table int32 [79, 257] (every context's cdf row), slots int32 [W] (slot
// words ctx | kind << 8 | arg << 12, ctx < 79), words int32 [n_words] (u16
// values), init int64 [N] (u32 states); reads at or past n_valid code
// nothing (n_valid = R: none), escape lengths clamp to M. Writes out u8 [R,
// W] (read r = lane * r_pl + row), fin int64 [N] and ptr_out int64 [1]
// (words consumed). Returns the cudaError of the launch (0 = launched).
extern "C" int fqtz_id_decode(const void* table, const void* slots, int W,
                              int r_pl, const void* words, int n_words,
                              const void* init, int N, int sb, int n_valid,
                              int M, void* out, void* fin, void* ptr_out,
                              void* stream) {
  return launch<kIds>(table, kIdRows, slots, W, r_pl, words, n_words, init,
                      N, sb, n_valid, M, out, fin, ptr_out, stream);
}

// Launches K5 on `stream`: the same for the W = 2 or 3 meta slots of every
// read, slot k reading row k of table int32 [W, 257]; every slot active.
extern "C" int fqtz_meta_decode(const void* table, int W, int r_pl,
                                const void* words, int n_words,
                                const void* init, int N, int sb, void* out,
                                void* fin, void* ptr_out, void* stream) {
  if (W < 1 || W > kMaxMetaRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kMeta>(table, W, nullptr, W, r_pl, words, n_words, init, N,
                       sb, N * r_pl, 0, out, fin, ptr_out, stream);
}
