// Re-uploading gate chain, forward pass and its adjoint backward, for NVIDIA
// Hopper (sm_90a).
//
// gate_chain_fwd_kernel replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_fwd_kernel (entry gate_chain_planes
// -> _gate_chain_fwd_call). For every sample b it runs, from |0...0>,
// n_layers = L*k layers:
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
// Forward design. One thread block per sample with max(d/2, 32) threads; the
// sample's state (2 x d floats, 8 KB at w=10), its phase column, the k sign
// planes and all n_layers*w*8 gate scalars sit in shared memory for the
// whole chain, so the state is read from and written to device memory once.
// Each thread updates one amplitude pair (i0, i0 | bit) per gate, with a
// __syncthreads() between gates.
//
// What bounds the forward on this card. At the sampling shape (w=6, B=16,
// L*k=28) the work is 28*6*32*16 pair updates (~86k, ~1 MFLOP) per launch:
// neither FLOPs nor bandwidth matter. The launch latency and the chain of
// ~210 block-wide barriers do, and only B of the 132 SMs get a block.
// Reading a column of a (d, B) plane with stride B is uncoalesced; at these
// sizes it is accepted (d*B*16 bytes per launch). Multi-sample blocks, a
// sample-major layout and wgmma for wide states are later work.
//
// gate_chain_bwd_kernel replaces qiddm_tpu/sim/pallas_gate_kernel.py::
// _bwd_kernel (entry _gate_chain_bwd, gate gradient from _plane_dg). Given
// the forward output (fr, fi) and the output cotangent (gr, gi), it walks
// the chain in reverse, l = n_layers-1 .. 0:
//   * multiply state and cotangent by signs[l % k] (CZ is self-inverse);
//   * for j = w-1 .. 0: the adjoint gate turns the state into the gate's
//     input; dg[l, j] pairs the output-side cotangent with that input state,
//     dg[x, y] = (sum c_x.r s_y.r + c_x.i s_y.i, sum c_x.i s_y.r - c_x.r s_y.i)
//     over rows whose wire bit is x (cotangent) and y (state); then the
//     adjoint gate carries the cotangent to the gate's input;
//   * at l % k == 0, undo the phase on the state and the cotangent and add
//     the phase gradient to (dpr, dpi).
// No per-layer state is stored: the states are rebuilt through inverse
// gates, as on the TPU.
//
// Backward design. The forward's layout: one block per sample, a thread per
// amplitude pair, and state, cotangent, phase column, dpr/dpi accumulators
// (8 x d floats, 32 KB at w=10), sign planes and gate scalars in shared
// memory. A thread undoes the gate on its state pair, forms its 8 dg
// partial products and updates its cotangent pair with no barrier in
// between. dg sums over rows and over the batch: a warp-shuffle reduction,
// then one across warps through shared memory (double-buffered by gate
// parity, so one barrier per gate suffices), gives each block's partial
// dg[b] in a (B, L*k, w, 8) workspace; gate_chain_dg_sum_kernel then sums
// it over b in a fixed order. No atomics: a seeded run gives the same bits
// every time.
//
// What bounds the backward on this card. At the training shape (w=6, B=10,
// L*k=28) the work is ~2x the forward's pair updates plus 8 products per
// pair per gate; as for the forward, launch latency and the ~400
// block-wide barriers bound it, and B of the 132 SMs are busy.
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
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

// Threads per block: one per amplitude pair, at least one warp.
int threads_for(int wires) {
  const int half = (1 << wires) / 2;
  return half > 32 ? half : 32;
}

__global__ void gate_chain_bwd_kernel(const float* __restrict__ pr,
                                      const float* __restrict__ pi,
                                      const float* __restrict__ g8,
                                      const float* __restrict__ signs,
                                      const float* __restrict__ fr,
                                      const float* __restrict__ fi,
                                      const float* __restrict__ gr,
                                      const float* __restrict__ gi,
                                      float* __restrict__ dg_part,
                                      float* __restrict__ dpr,
                                      float* __restrict__ dpi, int wires,
                                      int batch, int n_layers, int k) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sr = smem;            // state, real
  float* si = sr + d;          // state, imaginary
  float* cr = si + d;          // cotangent, real
  float* ci = cr + d;          // cotangent, imaginary
  float* ph_r = ci + d;        // phase column of sample b
  float* ph_i = ph_r + d;
  float* acc_r = ph_i + d;     // dpr[:, b] accumulator
  float* acc_i = acc_r + d;    // dpi[:, b] accumulator
  float* sg = acc_i + d;       // k sign planes
  float* g = sg + k * d;       // n_layers * wires * 8 gate scalars
  float* red = g + n_layers * wires * 8;  // 2 x nwarps x 8 warp partials

  for (int i = tid; i < d; i += nt) {
    const size_t at = static_cast<size_t>(i) * batch + b;
    sr[i] = fr[at];
    si[i] = fi[at];
    cr[i] = gr[at];
    ci[i] = gi[at];
    ph_r[i] = pr[at];
    ph_i[i] = pi[at];
    acc_r[i] = 0.0f;
    acc_i[i] = 0.0f;
  }
  for (int i = tid; i < k * d; i += nt) sg[i] = signs[i];
  for (int i = tid; i < n_layers * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

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
      const float* m = g + (l * wires + j) * 8;
      // the adjoint gate: a_xy = conj(g_yx)
      const float a00r = m[0], a00i = -m[1], a01r = m[4], a01i = -m[5];
      const float a10r = m[2], a10i = -m[3], a11r = m[6], a11i = -m[7];
      const int bit = 1 << (wires - 1 - j);
      float part[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) part[t] = 0.0f;
      if (tid < half) {
        const int lo = tid & (bit - 1);
        const int i0 = ((tid - lo) << 1) | lo;  // tid with a 0 at `bit`
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
        part[0] = c0r * t0r + c0i * t0i;  // dg00
        part[1] = c0i * t0r - c0r * t0i;
        part[2] = c0r * t1r + c0i * t1i;  // dg01
        part[3] = c0i * t1r - c0r * t1i;
        part[4] = c1r * t0r + c1i * t0i;  // dg10
        part[5] = c1i * t0r - c1r * t0i;
        part[6] = c1r * t1r + c1i * t1i;  // dg11
        part[7] = c1i * t1r - c1r * t1i;
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
      float* rb = red + parity * nwarps * 8;
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t) rb[warp * 8 + t] = part[t];
      }
      // also the barrier between gates: the next gate pairs other rows
      __syncthreads();
      if (tid < 8) {
        float s = 0.0f;
        for (int w8 = 0; w8 < nwarps; ++w8) s += rb[w8 * 8 + tid];
        dg_part[(static_cast<size_t>(b) * n_layers + l) * wires * 8 +
                j * 8 + tid] = s;
      }
      parity ^= 1;
    }
    if (l % k == 0) {
      for (int i = tid; i < d; i += nt) {
        const float p_r = ph_r[i], p_i = ph_i[i];
        const float a = sr[i], c = si[i];
        const float x = cr[i], y = ci[i];
        const float spr = a * p_r + c * p_i;  // state before the phase
        const float spi = c * p_r - a * p_i;
        acc_r[i] += x * spr + y * spi;
        acc_i[i] += y * spr - x * spi;
        sr[i] = spr;
        si[i] = spi;
        cr[i] = x * p_r + y * p_i;
        ci[i] = y * p_r - x * p_i;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < d; i += nt) {
    const size_t at = static_cast<size_t>(i) * batch + b;
    dpr[at] = acc_r[i];
    dpi[at] = acc_i[i];
  }
}

// dg[t] = sum over b of dg_part[b, t], b in increasing order.
__global__ void gate_chain_dg_sum_kernel(const float* __restrict__ dg_part,
                                         float* __restrict__ dg, int n,
                                         int batch) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float s = 0.0f;
  for (int b = 0; b < batch; ++b) s += dg_part[static_cast<size_t>(b) * n + t];
  dg[t] = s;
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
  gate_chain_fwd_kernel<<<batch, threads_for(wires), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pr), static_cast<const float*>(pi),
      static_cast<const float*>(g8), static_cast<const float*>(signs),
      static_cast<float*>(out_r), static_cast<float*>(out_i), wires, batch,
      n_layers, k);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes one backward block needs.
size_t gate_chain_bwd_smem_bytes(int wires, int n_layers, int k) {
  const size_t d = size_t{1} << wires;
  const size_t nwarps = threads_for(wires) / 32;
  return (8 * d + static_cast<size_t>(k) * d +
          static_cast<size_t>(n_layers) * wires * 8 + 2 * nwarps * 8) *
         sizeof(float);
}

// dg_part is (batch, n_layers, wires, 8) scratch; dg is (n_layers, wires, 8);
// dpr, dpi are (d, batch).
int gate_chain_bwd(const void* pr, const void* pi, const void* g8,
                   const void* signs, const void* fr, const void* fi,
                   const void* gr, const void* gi, void* dg_part, void* dg,
                   void* dpr, void* dpi, int wires, int batch, int n_layers,
                   int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_chain_bwd_smem_bytes(wires, n_layers, k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gate_chain_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gate_chain_bwd_kernel<<<batch, threads_for(wires), smem, s>>>(
      static_cast<const float*>(pr), static_cast<const float*>(pi),
      static_cast<const float*>(g8), static_cast<const float*>(signs),
      static_cast<const float*>(fr), static_cast<const float*>(fi),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<float*>(dg_part), static_cast<float*>(dpr),
      static_cast<float*>(dpi), wires, batch, n_layers, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = n_layers * wires * 8;
  gate_chain_dg_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dg_part), static_cast<float*>(dg), n, batch);
  return static_cast<int>(cudaGetLastError());
}

const char* gate_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
