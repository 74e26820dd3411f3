// Pieces shared by the chain kernels (gate_chain.cu, ry_chain.cu,
// sel_chain.cu, whose bodies are in chain_regs.cuh) and in part by the
// density-matrix block and the unitary-streaming chain (dm_chain.cu,
// unitary_chain.cu): the shared-memory opt-in, one 2x2 gate on an
// amplitude pair, and the fixed-order batch sum of dg.
//
// Conventions of these files: wire 0 is the most significant bit of the
// basis index, d = 2^w; a gate is 8 floats
// (g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i).
//
// Everything here sits in an anonymous namespace, so each source that
// includes it gets its own copy and the library links without clashes.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Lets `kernel` take `smem` bytes of dynamic shared memory; above 48 KB
// Hopper needs the opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The gate m on one amplitude pair (s0, s1), in place. Each output sums
// its four products left to right, as fused multiply-adds on the first
// product, written out so that every kernel that inlines it rounds alike:
// the SEL chain's planes and rows kernels give the same bits.
__device__ __forceinline__ void gate_pair(const float* m, float& s0r,
                                          float& s0i, float& s1r,
                                          float& s1i) {
  const float a0r = s0r, a0i = s0i, a1r = s1r, a1i = s1i;
  s0r = fmaf(-m[3], a1i, fmaf(m[2], a1r, fmaf(-m[1], a0i, m[0] * a0r)));
  s0i = fmaf(m[3], a1r, fmaf(m[2], a1i, fmaf(m[1], a0r, m[0] * a0i)));
  s1r = fmaf(-m[7], a1i, fmaf(m[6], a1r, fmaf(-m[5], a0i, m[4] * a0r)));
  s1i = fmaf(m[7], a1r, fmaf(m[6], a1i, fmaf(m[5], a0r, m[4] * a0i)));
}

// dg[t] = sum over b of dg_part[b, t], b in increasing order.
__global__ void dg_batch_sum_kernel(const float* __restrict__ dg_part,
                                    float* __restrict__ dg, int n,
                                    int batch) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float s = 0.0f;
  for (int b = 0; b < batch; ++b) s += dg_part[static_cast<size_t>(b) * n + t];
  dg[t] = s;
}

// Launches dg_batch_sum_kernel over n = (layers * wires * 8) entries.
cudaError_t launch_dg_batch_sum(const float* dg_part, float* dg, int n,
                                int batch, cudaStream_t stream) {
  dg_batch_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(dg_part, dg, n,
                                                           batch);
  return cudaGetLastError();
}

}  // namespace
