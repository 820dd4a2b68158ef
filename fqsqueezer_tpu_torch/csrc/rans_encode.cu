// K1: the reverse interleaved-rANS encode walk of every stream of one group
// flush, in one launch.
//
// Replaces fqsqueezer_tpu/ops/rans.py:_rans_encode_kernel (launched by
// _rans_encode_pallas from rans_encode and rans_encode_group). Same values:
// for t = T-1 .. 0 and every lane,
//   emit = (x >> (32-SB)) >= f;  w[t] = x & 0xFFFF;  if (emit) x >>= 16;
//   x = ((x / f) << SB) + c + x % f.
// The Pallas kernel walked one grid in 256-row chunks on a sequential TPU
// grid and emulated the u32 divide with f32 digits. Neither carries over.
//
// What bounds it on an H100: not bytes. A walk is T dependent steps a lane,
// and lanes never interact, so the floor is T times the latency of one
// step's dependent instructions (the chain floor). The byte bound (f and c
// read once, words and emit flags written once) lies several times below it
// at the main path's T of a few thousand rows. The design keeps everything
// but the recurrence itself off that chain:
//  * One block owns a strip of 32 lanes for the whole walk: one consumer
//    warp that runs the chain and kHelpers helper warps that feed it.
//    blockIdx.y picks the stream from a small table passed by value, so
//    2048 lanes x 3 streams are 192 blocks over the 132 SMs; the streams'
//    T and N may differ.
//  * The strip's f and c rows arrive through a ring of kStages tiles of
//    kRows rows in shared memory, filled by 16-byte cp.async copies that
//    the helper threads start kStages-1 tiles ahead (cp.async.commit_group
//    / wait_group). A helper thread prepares exactly the chunks it copied,
//    so its own wait_group orders the ring and no barrier guards it.
//  * The divide is taken off the chain. For each staged slot a helper
//    computes the reciprocal m = floor((2^32-1) / f), which gives
//    q' = umulhi(x, m) in {q-1, q} for every u32 x and every
//    1 <= f <= 2^16 (f = 1 included, where 2^32 / f does not fit), and
//    packs 2^SB - f with c. It writes both into a double-buffered prepared
//    tile one tile ahead of the consumer; one named barrier a tile hands
//    the tile over. A u32 divide has a latency of far more than a chain
//    step, which is why it takes several helper warps to keep up.
//  * On the chain a step is compare, select, multiply-high,
//    multiply-subtract, compare, select: the emit test is
//    x > (f << (32-SB)) - 1 in wrapping u32 arithmetic, never true for the
//    no-op row f = 2^SB, and both outcomes of the quotient's one
//    correction are formed beside its compare. The consumer reads shared
//    memory only.
//  * Words leave as u16 and emit flags as u8: 3 bytes a slot instead of 5.
// Grids whose N or base address does not allow 16-byte copies (N % 4 != 0)
// are read by the helpers with plain loads; partial strips and a ragged
// last tile are masked. The compaction of the emitted words stays in the
// wrapper.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;           // lanes a strip = threads a warp
constexpr int kRows = 64;            // rows a tile
constexpr int kStages = 4;           // raw tiles in the ring
constexpr int kHelpers = 8;          // warps that prepare tiles
constexpr int kThreads = kLanes * (1 + kHelpers);
constexpr int kHelperThreads = kLanes * kHelpers;
constexpr int kMaxStreams = 8;        // K1_MAX_STREAMS in ops/rans.py
constexpr int kMaxDevices = 16;      // cards whose opt-in is remembered
constexpr int kEpc = 4;                      // int32 elements a 16-byte chunk
constexpr int kCpr = kLanes / kEpc;          // chunks a strip row
constexpr int kChunks = kRows * kCpr;        // chunks a tile plane
constexpr int kCpt = kChunks / kHelperThreads;   // ... a helper thread
constexpr int kPlane = kRows * kLanes;       // elements a tile plane
constexpr int kSmemBytes = (kStages + 2) * 2 * kPlane * 4;
static_assert(kChunks % kHelperThreads == 0, "chunks divide over helpers");

struct Stream {
  const int32_t* f;
  const int32_t* c;
  const int64_t* init;   // u32 states, carried in 64 bits by the caller
  uint16_t* w;
  uint8_t* e;
  int64_t* fin;
  int T;
  int N;
};

struct StreamTable {
  Stream s[kMaxStreams];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The consumer warp and the helper warps meet here once a tile.
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// K1_CHAIN_ONLY is a timing build for tools/k1_compare.py and gives wrong
// values: the helpers skip the divide and the consumer neither reads a
// prepared row nor stores, so what is left is the chain floor.
__device__ __forceinline__ uint32_t recip(uint32_t f) {
#ifdef K1_CHAIN_ONLY
  return f * 2654435761u;
#else
  return 0xFFFFFFFFu / f;
#endif
}

// One row of the chain. m = floor((2^32-1) / f), g = 2^sb - f. Returns the
// emit flag; the word is x's low half before the call. Both outcomes of the
// quotient's correction are formed beside the compare, so the chain is
// compare, select, multiply-high, multiply-subtract, compare, select.
__device__ __forceinline__ bool step(uint32_t& x, uint32_t m, uint32_t gc,
                                     uint32_t two_sb, int shift) {
  const uint32_t c = gc & 0xFFFFu, g = gc >> 16, f = two_sb - g;
  const bool emit = x > (f << shift) - 1u;   // wraps to 2^32-1 for f = 2^sb
  const uint32_t x1 = emit ? (x >> 16) : x;
  const uint32_t q = __umulhi(x1, m);            // x1 / f or one less
  const uint32_t lo = x1 + c + q * g;            // (q << sb) + c + x1 - q * f
  x = (x1 - q * f >= f) ? lo + g : lo;
  return emit;
}

__global__ void __launch_bounds__(kThreads)
    rans_encode_walk_kernel(const StreamTable tab, const int sb) {
  const Stream s = tab.s[blockIdx.y];
  const int T = s.T, N = s.N;
  const int lane0 = blockIdx.x * kLanes;
  if (lane0 >= N) return;
  extern __shared__ uint4 smem16[];
  uint32_t* const raw = reinterpret_cast<uint32_t*>(smem16);
  uint32_t* const prep = raw + kStages * 2 * kPlane;
  const uint32_t two_sb = 1u << sb;
  const int n_tiles = (T + kRows - 1) / kRows;
  // Tile k holds rows [T-(k+1)*kRows, T-k*kRows); rows below 0 are left out.

  if (threadIdx.x >= kLanes) {
    // ---- helper warps: raw tiles in by cp.async, prepared tiles out ----
    const int h = threadIdx.x - kLanes;
    const bool vec = N % kEpc == 0 &&
                     reinterpret_cast<uintptr_t>(s.f) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(s.c) % 16 == 0;
    // A thread prepares the chunks it copied itself, so its own
    // wait_group is all the ordering the raw ring needs.
    auto copy_in = [&](int k) {
      if (vec && k < n_tiles) {
        const int base = T - (k + 1) * kRows;
        uint32_t* const rf = raw + (k % kStages) * 2 * kPlane;
#pragma unroll
        for (int i = 0; i < kCpt; ++i) {
          const int j = i * kHelperThreads + h;
          const int r = j / kCpr, col = (j % kCpr) * kEpc;
          if (base + r >= 0 && lane0 + col < N) {
            const size_t g = static_cast<size_t>(base + r) * N + lane0 + col;
            cp_async16(rf + r * kLanes + col, s.f + g);
            cp_async16(rf + kPlane + r * kLanes + col, s.c + g);
          }
        }
      }
      cp_async_commit();   // one group a tile, empty or not, keeps the count
    };
    for (int k = 0; k < kStages - 1; ++k) copy_in(k);
    for (int k = 0; k < n_tiles; ++k) {
      copy_in(k + kStages - 1);
      cp_async_wait<kStages - 1>();   // this thread's copies of tile k landed
      const int base = T - (k + 1) * kRows;
      const uint32_t* const rf = raw + (k % kStages) * 2 * kPlane;
      uint32_t* const pm = prep + (k % 2) * 2 * kPlane;
#pragma unroll
      for (int i = 0; i < kCpt; ++i) {
        const int j = i * kHelperThreads + h;
        const int r = j / kCpr, col = (j % kCpr) * kEpc;
        if (base + r < 0) continue;
        uint32_t f4[kEpc], c4[kEpc];
        if (vec && lane0 + col < N) {
          const uint4 fv = *reinterpret_cast<const uint4*>(
              rf + r * kLanes + col);
          const uint4 cv = *reinterpret_cast<const uint4*>(
              rf + kPlane + r * kLanes + col);
          f4[0] = fv.x, f4[1] = fv.y, f4[2] = fv.z, f4[3] = fv.w;
          c4[0] = cv.x, c4[1] = cv.y, c4[2] = cv.z, c4[3] = cv.w;
        } else {
#pragma unroll
          for (int e = 0; e < kEpc; ++e) {   // lanes past N walk no-ops
            const int lane = lane0 + col + e;
            const bool in = !vec && lane < N;
            const size_t g = static_cast<size_t>(base + r) * N + lane;
            f4[e] = in ? static_cast<uint32_t>(s.f[g]) : two_sb;
            c4[e] = in ? static_cast<uint32_t>(s.c[g]) : 0u;
          }
        }
        uint4 mv, gv;
        mv.x = recip(f4[0]), gv.x = ((two_sb - f4[0]) << 16) | c4[0];
        mv.y = recip(f4[1]), gv.y = ((two_sb - f4[1]) << 16) | c4[1];
        mv.z = recip(f4[2]), gv.z = ((two_sb - f4[2]) << 16) | c4[2];
        mv.w = recip(f4[3]), gv.w = ((two_sb - f4[3]) << 16) | c4[3];
        *reinterpret_cast<uint4*>(pm + r * kLanes + col) = mv;
        *reinterpret_cast<uint4*>(pm + kPlane + r * kLanes + col) = gv;
      }
      block_barrier();   // tile k is prepared; the consumer left tile k-1
    }
    return;
  }

  // ---- consumer warp: the chain, out of shared memory only ----
  const int tid = threadIdx.x;
  const int lane = lane0 + tid;
  const bool live = lane < N;
  const bool full = lane0 + kLanes <= N;
  const int shift = 32 - sb;
  uint32_t x = live ? static_cast<uint32_t>(s.init[lane]) : 0x10000u;
  for (int k = 0; k < n_tiles; ++k) {
    block_barrier();
    const int base = T - (k + 1) * kRows;
    const uint32_t* const pm = prep + (k % 2) * 2 * kPlane + tid;
    const uint32_t* const pg = pm + kPlane;
    uint16_t* const wp = s.w + static_cast<ptrdiff_t>(base) * N + lane;
    uint8_t* const ep = s.e + static_cast<ptrdiff_t>(base) * N + lane;
    if (base >= 0 && full) {       // no mask, so no branch between rows
#pragma unroll
      for (int r = kRows - 1; r >= 0; --r) {
#ifdef K1_CHAIN_ONLY
        step(x, pm[0], pg[0], two_sb, shift);
#else
        wp[r * N] = static_cast<uint16_t>(x);
        ep[r * N] =
            step(x, pm[r * kLanes], pg[r * kLanes], two_sb, shift) ? 1 : 0;
#endif
      }
    } else {       // a partial strip or the ragged last tile, row by row
      for (int r = kRows - 1; r >= 0 && base + r >= 0; --r) {
        const uint16_t word = static_cast<uint16_t>(x);
        const bool emit =
            step(x, pm[r * kLanes], pg[r * kLanes], two_sb, shift);
        if (live) {
          wp[r * N] = word;
          ep[r * N] = emit ? 1 : 0;
        }
      }
    }
  }
  if (live) s.fin[lane] = static_cast<int64_t>(x);
}

}  // namespace

// Launches the walks of n_streams grids (at most 8) on `stream`. Stream i:
// f[i], c[i] are int32 [T[i], N[i]] grids, init[i] and fin[i] int64 [N[i]]
// holding u32 states, w[i] u16 and e[i] u8 [T[i], N[i]]. Returns the
// cudaError of the launch (0 = launched).
extern "C" int fqtz_rans_encode_walk(int n_streams, const void* const* f,
                                     const void* const* c,
                                     const void* const* init, void* const* w,
                                     void* const* e, void* const* fin,
                                     const int* T, const int* N, int sb,
                                     void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || sb < 1 || sb > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamTable tab = {};
  int max_n = 0;
  for (int i = 0; i < n_streams; ++i) {
    tab.s[i] = Stream{static_cast<const int32_t*>(f[i]),
                      static_cast<const int32_t*>(c[i]),
                      static_cast<const int64_t*>(init[i]),
                      static_cast<uint16_t*>(w[i]),
                      static_cast<uint8_t*>(e[i]),
                      static_cast<int64_t*>(fin[i]),
                      T[i],
                      N[i]};
    if (T[i] < 0 || N[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    max_n = N[i] > max_n ? N[i] : max_n;
  }
  if (max_n == 0) return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory opt-in is a setting of the device: made once for each.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    rc = cudaFuncSetAttribute(rans_encode_walk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const dim3 grid((max_n + kLanes - 1) / kLanes, n_streams);
  rans_encode_walk_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(tab, sb);
  return static_cast<int>(cudaGetLastError());
}
