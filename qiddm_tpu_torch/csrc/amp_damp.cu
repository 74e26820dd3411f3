// One amplitude-damping trajectory pass (the Monte-Carlo unraveling of the
// channel on every wire, in wire order) for NVIDIA Hopper (sm_90a).
//
// amp_damp_fwd_kernel replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_amp_damp_kernel (entry
// amp_damp_call_planes, wrapper trajectories.py::_amp_damp_fused) and
// computes what its twin trajectories.py::_amp_damp_xla computes. For every
// state n (d = 2^w amplitudes, wire 0 the most significant bit of the basis
// index) and each wire j = 0..w-1 in order, on the state left by wires
// 0..j-1:
//   * p1 = g * sum_{i: bit_j(i) = 1} |psi_i|^2;
//   * pick = forced ? forced[j, n] : u[j, n] < p1;
//   * bit-0 amplitudes become pick ? sqrt(g) / sqrt(max(p1, 1e-30)) * partner
//                                  : own / sqrt(max(1 - p1, 1e-30));
//   * bit-1 amplitudes become pick ? 0
//                                  : sqrt(1 - g) / sqrt(max(1 - p1, 1e-30)) * own;
// and picks[j, n] records the branch taken. The JAX package has no backward
// kernel for this pass: its gradient replays the twin with the same uniforms
// (_amp_damp_fused_bwd), and the port's wrapper replays its plain twin with
// these picks forced (qiddm_tpu_torch/sim/amp_damp_kernel.py).
//
// Layout. The trajectory route hands over (N, d) complex64 rows, N = n_traj
// x batch, sample-major (trajectories.py flattens trajectories into the
// batch, row t*B + b), and takes the same layout back for its next
// elementwise encode and its readout. The kernel reads and writes those rows
// as float2 directly: one row is one contiguous 8 d byte run, so a block's
// load and store are coalesced and no transpose to (d, N) planes is paid on
// every call, as the TPU kernel's (d, B) lane layout would need.
//
// Design. One thread block per state; the state sits in shared memory
// (8 d bytes: 32 KB at w = 12) for the whole pass, so device memory sees one
// read and one write of it. min(max(d/2, 32), 1024) threads, each owning
// the amplitude pairs p = tid, tid + nt, ... < d/2 of the current wire. Per
// wire: each thread sums |psi|^2 over its pairs' bit-1 members, a warp
// shuffle and one barrier reduce the block's sum in a fixed order, every
// thread forms p1 and the pick, updates its pairs in place, and a second
// barrier closes the wire. The sums run in double: the products of float32
// values are exact there, so p1 does not depend on the order of the sum to
// float32 rounding and the pick u < p1 is the same as the plain twin's
// (which also sums in double) except at ties within ~1e-16. The strength is
// read on the device through a pointer when it is a tensor, so a sweep never
// synchronises with the host.
//
// What bounds it on this card. A pass reads and writes each state once:
// 2 * N * d * 8 bytes plus the w*N uniforms and picks. At the 12-wire
// bench shape (N = 1,000, w = 12) that is 65.6 MB, ~19.6 us at 3.35 TB/s;
// the arithmetic (~10 flops an amplitude a wire, ~0.5 GFLOP) is far below
// the float32 peak. What sets its time is the 2 w block-wide barriers and
// the shared-memory passes: each wire reads the whole state twice from
// shared memory. At w = 8 (256 amplitudes) a block has 128 threads and the
// card is short of work per block. Several states per block, or keeping a
// thread's pairs in registers across wires, are later work.
//
// Plain C interface (bound with ctypes): the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); gate_chain_error_string in gate_chain.cu names it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // threads_for's cap

__global__ void __launch_bounds__(kMaxThreads)
    amp_damp_fwd_kernel(const float2* __restrict__ states,
                        const float* __restrict__ u,
                        const float* __restrict__ strength_ptr,
                        float strength_val,
                        const uint8_t* __restrict__ forced,
                        float2* __restrict__ out,
                        uint8_t* __restrict__ picks, int wires, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[kMaxThreads / 32];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;
  float2* s = reinterpret_cast<float2*>(smem_raw);
  const float2* src = states + static_cast<size_t>(row) * d;
  for (int i = tid; i < d; i += nt) s[i] = src[i];

  const float g = strength_ptr != nullptr ? *strength_ptr : strength_val;
  const float sqg = sqrtf(fmaxf(g, 0.0f));
  const float sq1g = sqrtf(fmaxf(1.0f - g, 0.0f));
  __syncthreads();

  for (int j = 0; j < wires; ++j) {
    const int bit = 1 << (wires - 1 - j);
    double part = 0.0;
    for (int p = tid; p < half; p += nt) {
      const int lo = p & (bit - 1);
      const int i1 = (((p - lo) << 1) | lo) | bit;
      const float2 v = s[i1];
      part += static_cast<double>(v.x) * v.x + static_cast<double>(v.y) * v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    double prob1 = 0.0;
    for (int w8 = 0; w8 < nwarps; ++w8) prob1 += red[w8];
    const double p1d = static_cast<double>(g) * prob1;
    const size_t at = static_cast<size_t>(j) * n + row;
    const bool pick = forced != nullptr
                          ? forced[at] != 0
                          : static_cast<double>(u[at]) < p1d;
    if (tid == 0) picks[at] = pick ? 1 : 0;
    const float p1 = static_cast<float>(p1d);
    const float c1 = sqg * rsqrtf(fmaxf(p1, 1e-30f));
    const float c0 = rsqrtf(fmaxf(1.0f - p1, 1e-30f));
    const float c0g = c0 * sq1g;
    for (int p = tid; p < half; p += nt) {
      const int lo = p & (bit - 1);
      const int i0 = ((p - lo) << 1) | lo;
      const int i1 = i0 | bit;
      const float2 v0 = s[i0];
      const float2 v1 = s[i1];
      if (pick) {
        s[i0] = make_float2(c1 * v1.x, c1 * v1.y);
        s[i1] = make_float2(0.0f, 0.0f);
      } else {
        s[i0] = make_float2(c0 * v0.x, c0 * v0.y);
        s[i1] = make_float2(c0g * v1.x, c0g * v1.y);
      }
    }
    // the next wire pairs other amplitudes and rewrites red
    __syncthreads();
  }

  float2* dst = out + static_cast<size_t>(row) * d;
  for (int i = tid; i < d; i += nt) dst[i] = s[i];
}

// Dynamic shared-memory bytes one block needs: the state.
size_t amp_damp_smem_bytes(int wires) {
  return (size_t{1} << wires) * sizeof(float2);
}

}  // namespace

extern "C" {

// states and out are (n, d) complex64 rows; u is (wires, n) float32; the
// strength is read from strength_ptr (a float on the device) unless it is
// null, else taken from strength; forced is (wires, n) uint8 branch picks to
// follow, or null to draw them from u; picks is (wires, n) uint8, written
// whole.
int amp_damp_fwd(const void* states, const void* u, const void* strength_ptr,
                 float strength, const void* forced, void* out, void* picks,
                 int wires, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = amp_damp_smem_bytes(wires);
  err = allow_smem(amp_damp_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  amp_damp_fwd_kernel<<<n, threads_for(wires), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(states), static_cast<const float*>(u),
      static_cast<const float*>(strength_ptr), strength,
      static_cast<const uint8_t*>(forced), static_cast<float2*>(out),
      static_cast<uint8_t*>(picks), wires, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
