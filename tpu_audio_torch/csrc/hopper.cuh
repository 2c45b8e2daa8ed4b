// Hopper helpers of the stacks that chain programmatic dependent launches
// (fused_decoder.cu, fused_decoder_lanes.cu, fused_llama_lanes.cu): the
// dependency wait and release of PDL, 16-byte streaming loads, cp.async
// copies into shared memory, a 16-byte int8 dot product; on the host, the
// launch chain of one call (Chain) and the shared-memory opt-in of its
// kernels (configure).
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace {

__device__ __forceinline__ void dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// a 16-byte read-only load that does not allocate in L1 (each weight is
// read once a call)
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Stream-ordered launches of one call: every launch after the first is a
// programmatic dependent launch, except the first after a copy (a tap),
// which waits for it in full. The first error stops the chain, and the
// entry returns it.
class Chain {
 public:
  explicit Chain(cudaStream_t stream) : stream_(stream) {}

  template <typename... Exp, typename... Act>
  void launch(void (*kernel)(Exp...), dim3 grid, dim3 block, size_t smem, Act&&... args) {
    if (err_ != cudaSuccess) return;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream_;
    cfg.attrs = attr;
    cfg.numAttrs = whole_ ? 0 : 1;
    err_ = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
    whole_ = false;
  }

  void copy(cudaError_t e) {  // a copy was enqueued between two launches
    keep(e);
    whole_ = true;
  }

  void keep(cudaError_t e) {
    if (err_ == cudaSuccess) err_ = e;
  }

  cudaError_t error() const { return err_; }

 private:
  cudaStream_t stream_;
  bool whole_ = true;
  cudaError_t err_ = cudaSuccess;
};

// Lets `kernel` take all the dynamic shared memory a block may opt into
// beside its static shared memory, and keeps the SMs' split between L1 and
// shared memory at the most shared memory while it runs. Every kernel of
// the chain asks for the same split, so that an SM never has to drain to
// change it before it takes a block of the next launch.
cudaError_t configure(const void* kernel, int opt_in) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             opt_in - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace
