// Re-uploading gate chain, forward pass, for NVIDIA Hopper (sm_90a).
//
// Replaces qiddm_tpu/sim/pallas_gate_kernel.py::_fwd_kernel (entry
// gate_chain_planes -> _gate_chain_fwd_call). For every sample b it runs,
// from |0...0>, n_layers = L*k layers:
//   * at l % k == 0, multiply by the sample's RZ phase plane (pr, pi)[:, b]
//     (before that layer's rotations);
//   * a 2x2 complex gate on each wire j = 0..w-1, wire 0 = most significant
//     bit of the basis index, gate components
//     (g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i);
//   * the CZ-ring sign plane signs[l % k] (the range cycles per block of k
//     layers, not over the full depth).
// Inputs and outputs keep the JAX entry's (d, B) float32 plane layout,
// d = 2^w, so the kernel and its plain PyTorch version take the same tensors.
//
// Design. One thread block per sample with max(d/2, 32) threads; the
// sample's state (2 x d floats, 8 KB at w=10), its phase column, the k sign
// planes and all n_layers*w*8 gate scalars sit in shared memory for the
// whole chain, so the state is read from and written to device memory once.
// Each thread updates one amplitude pair (i0, i0 | bit) per gate, with a
// __syncthreads() between gates.
//
// What bounds it on this card. At the sampling shape (w=6, B=16, L*k=28)
// the work is 28*6*32*16 pair updates (~86k, ~1 MFLOP) per launch: neither
// FLOPs nor bandwidth matter. The launch latency and the chain of ~210
// block-wide barriers do, and only B of the 132 SMs get a block. Reading a
// column of a (d, B) plane with stride B is uncoalesced; at these sizes it
// is accepted (d*B*16 bytes per launch). Multi-sample blocks, a
// sample-major layout and wgmma for wide states are later work.
//
// Plain C interface (bound with ctypes): the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void gate_chain_fwd_kernel(const float* __restrict__ pr,
                                      const float* __restrict__ pi,
                                      const float* __restrict__ g8,
                                      const float* __restrict__ signs,
                                      float* __restrict__ out_r,
                                      float* __restrict__ out_i,
                                      int wires, int batch, int n_layers,
                                      int k) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* sr = smem;            // state, real
  float* si = sr + d;          // state, imaginary
  float* ph_r = si + d;        // phase column of sample b
  float* ph_i = ph_r + d;
  float* sg = ph_i + d;        // k sign planes
  float* g = sg + k * d;       // n_layers * wires * 8 gate scalars

  for (int i = tid; i < d; i += nt) {
    sr[i] = (i == 0) ? 1.0f : 0.0f;
    si[i] = 0.0f;
    ph_r[i] = pr[static_cast<size_t>(i) * batch + b];
    ph_i[i] = pi[static_cast<size_t>(i) * batch + b];
  }
  for (int i = tid; i < k * d; i += nt) sg[i] = signs[i];
  for (int i = tid; i < n_layers * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    if (l % k == 0) {
      for (int i = tid; i < d; i += nt) {
        const float a = sr[i], c = si[i];
        sr[i] = a * ph_r[i] - c * ph_i[i];
        si[i] = a * ph_i[i] + c * ph_r[i];
      }
      __syncthreads();
    }
    for (int j = 0; j < wires; ++j) {
      const float* m = g + (l * wires + j) * 8;
      const int bit = 1 << (wires - 1 - j);
      for (int p = tid; p < half; p += nt) {
        const int lo = p & (bit - 1);
        const int i0 = ((p - lo) << 1) | lo;  // p with a 0 inserted at `bit`
        const int i1 = i0 | bit;
        const float s0r = sr[i0], s0i = si[i0];
        const float s1r = sr[i1], s1i = si[i1];
        sr[i0] = m[0] * s0r - m[1] * s0i + m[2] * s1r - m[3] * s1i;
        si[i0] = m[0] * s0i + m[1] * s0r + m[2] * s1i + m[3] * s1r;
        sr[i1] = m[4] * s0r - m[5] * s0i + m[6] * s1r - m[7] * s1i;
        si[i1] = m[4] * s0i + m[5] * s0r + m[6] * s1i + m[7] * s1r;
      }
      __syncthreads();
    }
    const float* sgl = sg + (l % k) * d;
    for (int i = tid; i < d; i += nt) {
      sr[i] *= sgl[i];
      si[i] *= sgl[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < d; i += nt) {
    out_r[static_cast<size_t>(i) * batch + b] = sr[i];
    out_i[static_cast<size_t>(i) * batch + b] = si[i];
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t gate_chain_fwd_smem_bytes(int wires, int n_layers, int k) {
  const size_t d = size_t{1} << wires;
  return (4 * d + static_cast<size_t>(k) * d +
          static_cast<size_t>(n_layers) * wires * 8) * sizeof(float);
}

int gate_chain_fwd(const void* pr, const void* pi, const void* g8,
                   const void* signs, void* out_r, void* out_i, int wires,
                   int batch, int n_layers, int k, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_chain_fwd_smem_bytes(wires, n_layers, k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gate_chain_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int half = (1 << wires) / 2;
  const int threads = half > 32 ? half : 32;
  gate_chain_fwd_kernel<<<batch, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pr), static_cast<const float*>(pi),
      static_cast<const float*>(g8), static_cast<const float*>(signs),
      static_cast<float*>(out_r), static_cast<float*>(out_i), wires, batch,
      n_layers, k);
  return static_cast<int>(cudaGetLastError());
}

const char* gate_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
