// RY-encoded re-uploading chain, forward pass and its adjoint backward, for
// NVIDIA Hopper (sm_90a).
//
// ry_chain_fwd_kernel replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_ry_fwd_kernel (entry
// ry_chain_planes -> _ry_chain_fwd_call). It is gate_chain.cu's forward with
// another encode: for every sample b it runs, from |0...0>, n_layers = L*k
// layers:
//   * at l % k == 0, before that layer's rotations, RY(x_j) on each wire j:
//     the real gate [[c_j, -s_j], [s_j, c_j]] with (c_j, s_j) = (cos, sin)
//     of x_j / 2, read from column b of cs (2w, B): rows 0..w-1 the cosines,
//     rows w..2w-1 the sines. Rows whose wire bit is 0 get c*own - s*partner,
//     rows whose bit is 1 get c*own + s*partner;
//   * a 2x2 complex gate on each wire j = 0..w-1 (wire 0 = most significant
//     bit of the basis index), gate components
//     (g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i);
//   * the CZ-ring sign plane signs[l % k] (the range cycles per block of k
//     layers, as in gate_chain.cu, not over the full depth as in
//     sel_chain.cu).
// Inputs and outputs keep the JAX entry's layout: cs (2w, B), states (d, B)
// float32 planes, d = 2^w.
//
// Design. The forward is gate_chain.cu's: one thread block per sample with
// max(d/2, 32) threads, state, sign planes and gate scalars in shared
// memory for the whole chain, one amplitude pair per thread per gate. The
// sample's w encode gates are built once, as 8-float gates
// (c, 0, -s, 0, s, 0, c, 0), so the encode runs through the same
// gate_pairs() update as the rotations (chain_common.cuh). The TPU kernel's
// lane-broadcast (1, B) coefficient rows and its concatenation of dcs rows
// exist for Mosaic's layout and have no counterpart here.
//
// ry_chain_bwd_kernel replaces qiddm_tpu/sim/pallas_gate_kernel.py::
// _ry_bwd_kernel (entry _ry_chain_bwd). Given the forward output (fr, fi)
// and the output cotangent (gr, gi) it walks the chain in reverse, l =
// n_layers-1 .. 0, as gate_chain.cu's backward does (signs, then the
// adjoint step of each rotation, j = w-1 .. 0, with dg[l, j] into the
// per-sample workspace), and at l % k == 0 un-encodes: for j = w-1 .. 0 the
// adjoint step of the encode gate, RY(-x_j), turns the state into the
// encode's input and carries the cotangent back; its 8-scalar dg gives the
// sample's encode gradient
//   dc_j = dg[0] + dg[6]  (g00r + g11r),  ds_j = dg[4] - dg[2]  (g10r - g01r),
// which thread j adds into registers over the L re-uploads and writes to
// dcs[j, b] and dcs[w + j, b] at the end. These sums are per sample: no
// batch reduction. The rotations' dg is summed over the batch by
// dg_batch_sum_kernel in a fixed order; no atomics, so two calls give the
// same bits.
//
// What bounds these kernels on this card. At QIDDM_PL_noise1's shape (w=8,
// L*k=12, B=10 in training, 16 in sampling) the forward does ~120 gate
// updates of 128 amplitude pairs per sample (~2.6 MFLOP at B=10) and moves
// ~40 KB: at the card's peaks that is well under a microsecond. What sets
// the time is the launch, the chain of block-wide barriers (one per gate:
// ~150 forward, ~200 backward) and that only B of the 132 SMs get a block.
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"

namespace {

// The sample's w encode gates RY(x_j) as 8-float gates, from column b of cs.
__device__ __forceinline__ void load_encode_gates(const float* __restrict__ cs,
                                                  float* enc, int wires,
                                                  int batch, int b) {
  for (int j = threadIdx.x; j < wires; j += blockDim.x) {
    const float c = cs[static_cast<size_t>(j) * batch + b];
    const float s = cs[static_cast<size_t>(wires + j) * batch + b];
    float* m = enc + j * 8;
    m[0] = c;
    m[1] = 0.0f;
    m[2] = -s;
    m[3] = 0.0f;
    m[4] = s;
    m[5] = 0.0f;
    m[6] = c;
    m[7] = 0.0f;
  }
}

__global__ void ry_chain_fwd_kernel(const float* __restrict__ cs,
                                    const float* __restrict__ g8,
                                    const float* __restrict__ signs,
                                    float* __restrict__ out_r,
                                    float* __restrict__ out_i, int wires,
                                    int batch, int n_layers, int k) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* sr = smem;            // state, real
  float* si = sr + d;          // state, imaginary
  float* enc = si + d;         // wires x 8: the sample's encode gates
  float* sg = enc + wires * 8; // k sign planes
  float* g = sg + k * d;       // n_layers * wires * 8 gate scalars

  for (int i = tid; i < d; i += nt) {
    sr[i] = (i == 0) ? 1.0f : 0.0f;
    si[i] = 0.0f;
  }
  load_encode_gates(cs, enc, wires, batch, b);
  for (int i = tid; i < k * d; i += nt) sg[i] = signs[i];
  for (int i = tid; i < n_layers * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    if (l % k == 0) {
      for (int j = 0; j < wires; ++j) {
        gate_pairs(sr, si, enc + j * 8, 1 << (wires - 1 - j), half);
        __syncthreads();
      }
    }
    for (int j = 0; j < wires; ++j) {
      gate_pairs(sr, si, g + (l * wires + j) * 8, 1 << (wires - 1 - j), half);
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

__global__ void ry_chain_bwd_kernel(const float* __restrict__ cs,
                                    const float* __restrict__ g8,
                                    const float* __restrict__ signs,
                                    const float* __restrict__ fr,
                                    const float* __restrict__ fi,
                                    const float* __restrict__ gr,
                                    const float* __restrict__ gi,
                                    float* __restrict__ dg_part,
                                    float* __restrict__ dcs, int wires,
                                    int batch, int n_layers, int k) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  float* sr = smem;                 // state, real
  float* si = sr + d;               // state, imaginary
  float* cr = si + d;               // cotangent, real
  float* ci = cr + d;               // cotangent, imaginary
  float* enc = ci + d;              // wires x 8: the sample's encode gates
  float* enc_dg = enc + wires * 8;  // wires x 8: their dg in one re-upload
  float* sg = enc_dg + wires * 8;   // k sign planes
  float* g = sg + k * d;            // n_layers * wires * 8 gate scalars
  float* red = g + n_layers * wires * 8;  // 2 x nwarps x 8 warp partials

  for (int i = tid; i < d; i += nt) {
    const size_t at = static_cast<size_t>(i) * batch + b;
    sr[i] = fr[at];
    si[i] = fi[at];
    cr[i] = gr[at];
    ci[i] = gi[at];
  }
  load_encode_gates(cs, enc, wires, batch, b);
  for (int i = tid; i < k * d; i += nt) sg[i] = signs[i];
  for (int i = tid; i < n_layers * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

  // thread j < wires carries (dc_j, ds_j) of this sample over the re-uploads
  float dc = 0.0f;
  float ds = 0.0f;
  int parity = 0;
  for (int l = n_layers - 1; l >= 0; --l) {
    const float* sgl = sg + (l % k) * d;
    for (int i = tid; i < d; i += nt) {
      sr[i] *= sgl[i];
      si[i] *= sgl[i];
      cr[i] *= sgl[i];
      ci[i] *= sgl[i];
    }
    __syncthreads();
    for (int j = wires - 1; j >= 0; --j) {
      adjoint_gate_step(
          sr, si, cr, ci, g + (l * wires + j) * 8, 1 << (wires - 1 - j), half,
          red + parity * nwarps * 8,
          dg_part + (static_cast<size_t>(b) * n_layers + l) * wires * 8 +
              j * 8);
      parity ^= 1;
    }
    if (l % k == 0) {
      for (int j = wires - 1; j >= 0; --j) {
        adjoint_gate_step(sr, si, cr, ci, enc + j * 8, 1 << (wires - 1 - j),
                          half, red + parity * nwarps * 8, enc_dg + j * 8);
        parity ^= 1;
      }
      __syncthreads();  // threads 0..7 wrote enc_dg after the last barrier
      if (tid < wires) {
        const float* e = enc_dg + tid * 8;
        dc += e[0] + e[6];
        ds += e[4] - e[2];
      }
    }
  }

  if (tid < wires) {
    dcs[static_cast<size_t>(tid) * batch + b] = dc;
    dcs[static_cast<size_t>(wires + tid) * batch + b] = ds;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one forward block needs; the wrapper checks it against
// the card's per-block limit before launching.
size_t ry_chain_fwd_smem_bytes(int wires, int n_layers, int k) {
  const size_t d = size_t{1} << wires;
  return (2 * d + static_cast<size_t>(wires) * 8 +
          static_cast<size_t>(k) * d +
          static_cast<size_t>(n_layers) * wires * 8) *
         sizeof(float);
}

// cs is (2 * wires, batch); out_r, out_i are (d, batch).
int ry_chain_fwd(const void* cs, const void* g8, const void* signs,
                 void* out_r, void* out_i, int wires, int batch, int n_layers,
                 int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ry_chain_fwd_smem_bytes(wires, n_layers, k);
  err = allow_smem(ry_chain_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ry_chain_fwd_kernel<<<batch, threads_for(wires), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), static_cast<const float*>(g8),
      static_cast<const float*>(signs), static_cast<float*>(out_r),
      static_cast<float*>(out_i), wires, batch, n_layers, k);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes one backward block needs.
size_t ry_chain_bwd_smem_bytes(int wires, int n_layers, int k) {
  const size_t d = size_t{1} << wires;
  const size_t nwarps = threads_for(wires) / 32;
  return (4 * d + static_cast<size_t>(wires) * 16 +
          static_cast<size_t>(k) * d +
          static_cast<size_t>(n_layers) * wires * 8 + 2 * nwarps * 8) *
         sizeof(float);
}

// dg_part is (batch, n_layers, wires, 8) scratch; dg is (n_layers, wires, 8);
// dcs is (2 * wires, batch).
int ry_chain_bwd(const void* cs, const void* g8, const void* signs,
                 const void* fr, const void* fi, const void* gr,
                 const void* gi, void* dg_part, void* dg, void* dcs, int wires,
                 int batch, int n_layers, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ry_chain_bwd_smem_bytes(wires, n_layers, k);
  err = allow_smem(ry_chain_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ry_chain_bwd_kernel<<<batch, threads_for(wires), smem, s>>>(
      static_cast<const float*>(cs), static_cast<const float*>(g8),
      static_cast<const float*>(signs), static_cast<const float*>(fr),
      static_cast<const float*>(fi), static_cast<const float*>(gr),
      static_cast<const float*>(gi), static_cast<float*>(dg_part),
      static_cast<float*>(dcs), wires, batch, n_layers, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dg_batch_sum(
      static_cast<const float*>(dg_part), static_cast<float*>(dg),
      n_layers * wires * 8, batch, s));
}

}  // extern "C"
