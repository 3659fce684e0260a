// Thread-block clusters (sm_90): the pieces the two-CTA n = 64 backward
// kernels use, each a small function around inline PTX, and their launch.
// A cluster's CTAs run at once on neighbouring SMs and can read each
// other's shared memory (distributed shared memory).  Under QV_EMULATE
// the host versions in tests/cuda_emulation/qv_emulate.h stand in: a
// cluster's CTAs run as threads at once, each with its own shared memory,
// and a read of the partner's shared memory sees it as the partner left
// it at its last cluster barrier, so a read the barrier does not order
// shows the NaN fill or stale rows in the tests.
#pragma once
#include "common.cuh"

namespace qv {

#ifndef QV_EMULATE
// this CTA's rank in its cluster
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the cluster barrier in two halves: arrive (release: this CTA's earlier
// writes, shared and global, are visible to the cluster's CTAs once they
// have waited) and wait (acquire: until every CTA of the cluster has
// arrived).  Every thread of each CTA takes part; a thread waits before it
// arrives again.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// the address of *p (this CTA's shared memory) in CTA `rank`'s shared
// memory, for plain loads
template <typename T>
__device__ __forceinline__ const T* cluster_peer(const T* p, unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}
#endif

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The pair's sums of the n floats each CTA of a two-CTA cluster left at
// `mine` (the same offset of each one's shared memory), in rank order:
// store(i, v) gets v = rank 0's [i] + rank 1's [i], each i by one thread
// of one CTA (rank h the i = h NTHREADS + threadIdx.x + 2 NTHREADS k), so
// the pair stores every element once, half each.  Call it after a
// cluster barrier that follows both CTAs' writes of `mine` (before it
// the partner's floats are not its sums), and keep `mine` until the
// partner has read it (its next cluster arrival).
template <typename F>
__device__ __forceinline__ void pair_sums(const float* mine, int n,
                                          F&& store) {
  const unsigned rank = cluster_rank();
  const float* s0 = rank ? cluster_peer(mine, 0u) : mine;
  const float* s1 = rank ? mine : cluster_peer(mine, 1u);
#pragma unroll 4
  for (int i = threadIdx.x + (int)rank * NTHREADS; i < n; i += 2 * NTHREADS)
    store(i, s0[i] + s1[i]);
}

}  // namespace qv

#ifndef QV_EMULATE
// Launch a unit kernel on `clusters` clusters of `csize` CTAs each (the
// CTAs of cluster c are blocks csize c ..), `smem_bytes` of dynamic
// shared memory a CTA; returns the launch's CUDA error (a cluster shape
// the card refuses included), 0 if none.
template <typename A>
static int qv_launch_cluster(void (*kernel)(A), const A& a, size_t smem_bytes,
                             void* stream, int clusters, int csize) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(qv::NTHREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How a cluster launch of `kernel` sits on the card: CTAs resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and clusters of `csize`
// resident at once (cudaOccupancyMaxActiveClusters); the CUDA error.
template <typename A>
static int qv_cluster_occupancy(void (*kernel)(A), size_t smem_bytes,
                                int csize, int* per_sm, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      qv::NTHREADS,
                                                      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(qv::NTHREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
}
#else
template <typename A>
static int qv_cluster_occupancy(void (*)(A), size_t, int, int* per_sm,
                                int* clusters) {
  *per_sm = *clusters = 0;         // not known on the host
  return 0;
}
#endif
