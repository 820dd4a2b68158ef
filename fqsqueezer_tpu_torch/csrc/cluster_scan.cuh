// The exclusive scan that the decode scans K2 (dna_decode.cu), K3
// (qual_decode.cu), K4 and K5 (slot_decode.cu) run at every step, and their
// one-cluster launch.
//
// All N lanes of a decode share ONE word stream: at each step the lanes
// whose state fell below 2^16 take consecutive words of it in lane order,
// so every lane needs the number of takers before it among all N lanes.
// Both kernels hold one lane a thread and spread the lanes over one
// thread-block cluster (at most 16 blocks, on as many SMs). Each warp
// stores its ballot total into every block's shared memory (distributed
// shared memory), double-buffered by step parity, and ONE cluster barrier
// a step orders the stores; each warp then scans the at most 64 warp
// totals from its own shared memory with shuffles.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace fqtz {

namespace cg = cooperative_groups;

constexpr int kScanMaxWarps = 64;          // 2048 lanes, one a thread
constexpr int kPortableCluster = 8;        // blocks; above it: non-portable

// A block's share of the scan: the cluster's warp totals of one step,
// double-buffered by step parity (a block may store step t + 1's totals
// while another still reads step t's).
struct ScanSmem {
  int tot[2][kScanMaxWarps];
};

struct TakeScan {
  int rank;        // takers before this lane, in lane order, this step
  int total;       // takers in the cluster this step
};

// Every thread of every block of the cluster calls this once a step, in the
// same order. gw: the warp's index in the cluster (block rank x warps a
// block + warp), n_gw: the cluster's warps, n_blocks: its blocks (<= 32).
__device__ __forceinline__ TakeScan cluster_take_scan(
    cg::cluster_group& cluster, ScanSmem& sm, int& parity, bool take,
    int gw, int n_gw, int n_blocks) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int wl = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(kFull, take);
  const int mine = __popc(bal);
  if (wl < n_blocks)
    *cluster.map_shared_rank(&sm.tot[parity][gw], wl) = mine;
  cluster.sync();
  int inc0 = wl < n_gw ? sm.tot[parity][wl] : 0;
  int inc1 = wl + 32 < n_gw ? sm.tot[parity][wl + 32] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u0 = __shfl_up_sync(kFull, inc0, d);
    const int u1 = __shfl_up_sync(kFull, inc1, d);
    if (wl >= d) {
      inc0 += u0;
      inc1 += u1;
    }
  }
  const int tot0 = __shfl_sync(kFull, inc0, 31);
  const int at0 = __shfl_sync(kFull, inc0, gw & 31);
  const int at1 = __shfl_sync(kFull, inc1, gw & 31);
  const int total = tot0 + __shfl_sync(kFull, inc1, 31);
  const int before = (gw < 32 ? at0 : tot0 + at1) - mine;
  parity ^= 1;
  return {before + __popc(bal & ((1u << wl) - 1u)), total};
}

// Launches `kernel` on `stream` as ONE cluster of n_blocks blocks of
// `threads` threads, each with `smem` bytes of dynamic shared memory; a
// cluster of more than 8 blocks is non-portable (the H100 takes 16) and
// asks for it first, and so does more than 48 KB of dynamic shared memory
// a block. Returns the launch's cudaError.
template <typename... KParams, typename... Values>
cudaError_t launch_one_cluster_smem(void (*kernel)(KParams...), int n_blocks,
                                    int threads, size_t smem,
                                    cudaStream_t stream, Values... args) {
  if (n_blocks > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (smem > (size_t{48} << 10)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// launch_one_cluster_smem with no dynamic shared memory.
template <typename... KParams, typename... Values>
cudaError_t launch_one_cluster(void (*kernel)(KParams...), int n_blocks,
                               int threads, cudaStream_t stream,
                               Values... args) {
  return launch_one_cluster_smem(kernel, n_blocks, threads, 0, stream,
                                 args...);
}

}  // namespace fqtz
