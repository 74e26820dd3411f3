// Pieces shared by the gate-chain kernels (gate_chain.cu) and the SEL-chain
// kernels (sel_chain.cu), in part by the RY chain, the density-matrix block
// and the unitary-streaming chain (ry_chain.cu, dm_chain.cu,
// unitary_chain.cu):
// the block shape, the shared-memory opt-in, one 2x2 gate on a state held
// in shared memory, one step of the adjoint backward walk with its dg
// reduction, and the fixed-order batch sum of dg.
//
// Conventions of these files: a block holds one sample; wire 0 is the most
// significant bit of the basis index, d = 2^w; a gate is 8 floats
// (g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i).
//
// Everything here sits in an anonymous namespace, so each source that
// includes it gets its own copy and the library links without clashes.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Threads per block: one per amplitude pair, at least one warp and at most
// 1024 (the block limit); above 11 wires each thread owns several pairs.
inline int threads_for(int wires) {
  const int half = (1 << wires) / 2;
  if (half >= 1024) return 1024;
  return half > 32 ? half : 32;
}

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

// The gate m on the wire whose basis-index bit is `bit`: each thread
// updates the amplitude pairs (i0, i0 | bit) p = tid, tid + nt, ... < half.
// No barrier: the caller puts one between gates.
__device__ __forceinline__ void gate_pairs(float* sr, float* si,
                                           const float* m, int bit,
                                           int half) {
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int lo = p & (bit - 1);
    const int i0 = ((p - lo) << 1) | lo;  // p with a 0 inserted at `bit`
    const int i1 = i0 | bit;
    float s0r = sr[i0], s0i = si[i0];
    float s1r = sr[i1], s1i = si[i1];
    gate_pair(m, s0r, s0i, s1r, s1i);
    sr[i0] = s0r;
    si[i0] = s0i;
    sr[i1] = s1r;
    si[i1] = s1i;
  }
}

// One step of the adjoint walk for the gate m on the wire of `bit`; each
// thread takes the amplitude pairs p = tid, tid + nt, ... < half (one pair
// per thread up to 11 wires):
//   * the adjoint gate turns the state (sr, si) into the gate's input;
//   * dg pairs the output-side cotangent with that input state,
//     dg[x, y] = (sum c_x.r s_y.r + c_x.i s_y.i, sum c_x.i s_y.r - c_x.r s_y.i)
//     over rows whose wire bit is x (cotangent) and y (state);
//   * the adjoint gate carries the cotangent (cr, ci) to the gate's input.
// A thread's pairs add into its 8 partials in pair order; the block's 8
// sums go through warp shuffles, then across warps through
// rb (nwarps x 8 floats), and threads 0..7 write them to dg_out. The one
// barrier inside is also the barrier between gates; the caller alternates
// rb between two buffers, so a buffer is not rewritten before it is read.
__device__ __forceinline__ void adjoint_gate_step(float* sr, float* si,
                                                  float* cr, float* ci,
                                                  const float* m, int bit,
                                                  int half, float* rb,
                                                  float* dg_out) {
  const int tid = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the adjoint gate: a_xy = conj(g_yx)
  const float a00r = m[0], a00i = -m[1], a01r = m[4], a01i = -m[5];
  const float a10r = m[2], a10i = -m[3], a11r = m[6], a11i = -m[7];
  float part[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) part[t] = 0.0f;
  for (int p = tid; p < half; p += blockDim.x) {
    const int lo = p & (bit - 1);
    const int i0 = ((p - lo) << 1) | lo;  // p with a 0 at `bit`
    const int i1 = i0 | bit;
    const float s0r = sr[i0], s0i = si[i0];
    const float s1r = sr[i1], s1i = si[i1];
    // the gate's input state
    const float t0r = a00r * s0r - a00i * s0i + a01r * s1r - a01i * s1i;
    const float t0i = a00r * s0i + a00i * s0r + a01r * s1i + a01i * s1r;
    const float t1r = a10r * s0r - a10i * s0i + a11r * s1r - a11i * s1i;
    const float t1i = a10r * s0i + a10i * s0r + a11r * s1i + a11i * s1r;
    sr[i0] = t0r;
    si[i0] = t0i;
    sr[i1] = t1r;
    si[i1] = t1i;
    const float c0r = cr[i0], c0i = ci[i0];
    const float c1r = cr[i1], c1i = ci[i1];
    part[0] += c0r * t0r + c0i * t0i;  // dg00
    part[1] += c0i * t0r - c0r * t0i;
    part[2] += c0r * t1r + c0i * t1i;  // dg01
    part[3] += c0i * t1r - c0r * t1i;
    part[4] += c1r * t0r + c1i * t0i;  // dg10
    part[5] += c1i * t0r - c1r * t0i;
    part[6] += c1r * t1r + c1i * t1i;  // dg11
    part[7] += c1i * t1r - c1r * t1i;
    cr[i0] = a00r * c0r - a00i * c0i + a01r * c1r - a01i * c1i;
    ci[i0] = a00r * c0i + a00i * c0r + a01r * c1i + a01i * c1r;
    cr[i1] = a10r * c0r - a10i * c0i + a11r * c1r - a11i * c1i;
    ci[i1] = a10r * c0i + a10i * c0r + a11r * c1i + a11i * c1r;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float v = part[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    part[t] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < 8; ++t) rb[warp * 8 + t] = part[t];
  }
  // also the barrier between gates: the next gate pairs other rows
  __syncthreads();
  if (tid < 8) {
    float s = 0.0f;
    for (int w8 = 0; w8 < nwarps; ++w8) s += rb[w8 * 8 + tid];
    dg_out[tid] = s;
  }
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
