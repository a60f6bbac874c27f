// The state exchange of the tensor-core recurrence chains (K10, gru.cu;
// K8, lstm_recurrence.cu): 16-byte st.async stores into the peers'
// distributed shared memory, each completing bytes on the receiver's
// transaction mbarrier, so a CTA waits once a step for the data it needs
// and no cluster barrier runs; and the launch of a cluster of CLN CTAs
// (8, or the non-portable 16) with its occupancy query.

#pragma once

#include "lstm_cluster.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// this CTA's one arrival of the barrier's phase, expecting `bytes`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of parity `parity` to complete; after two seconds,
// trap (a fault the launch reports) rather than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  unsigned long long t0 = 0, now;
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta."
        "b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i % 256 == 0) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (i == 0)
        t0 = now;
      else if (now - t0 > 2000000000ull)
        asm volatile("trap;");
    }
  }
}

// 16 bytes to CTA `peer`'s shared memory at `dst` (this CTA's address of
// the same variable), completing 16 bytes of the peer's barrier `bar`
__device__ __forceinline__ void st_async16(float* dst, uint64_t* bar,
                                           int peer, float4 v) {
  uint32_t rd, rb;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(rd)
      : "r"(smem_addr(dst)), "r"(peer));
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(rb)
      : "r"(smem_addr(bar)), "r"(peer));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(rd),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rb)
      : "memory");
}

// Sets `kernel`'s shared memory and, above 8 CTAs, its non-portable
// cluster size; fills cfg for `clusters` clusters of CLN CTAs.
template <int CLN, typename Kernel>
int cluster_n_config(Kernel kernel, size_t smem, unsigned clusters,
                     cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err && CLN > 8)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(CLN * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

// launch `kernel` on ceil(B / 16) clusters of CLN CTAs
template <int CLN, typename Kernel, typename... Args>
int launch_cluster_n(Kernel kernel, size_t smem, int B, cudaStream_t stream,
                     Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = cluster_n_config<CLN>(kernel, smem,
                                  (unsigned)((B + BT - 1) / BT), cfg, attr);
  if (err) return err;
  cfg.stream = stream;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err) return err;
  return check_launch();
}

// how many clusters of `kernel` the card holds at once; -1 on an error
template <int CLN, typename Kernel>
int resident_cluster_n(Kernel kernel, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (cluster_n_config<CLN>(kernel, smem, 1, cfg, attr) ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg))
    return -1;
  return n;
}

}  // namespace
