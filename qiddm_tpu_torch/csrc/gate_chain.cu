// Re-uploading gate chain, forward pass and its adjoint backward, for NVIDIA
// Hopper (sm_90a).
//
// gate_chain_fwd_regs_kernel<w> replaces
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
// Forward and backward share chain_regs.cuh (with ry_chain.cu): the
// forward's body is chain_fwd<W, false>, the backward's adjoint_walk.
//
// Forward design (chain_regs.cuh): a template on the width; the sample's
// state and phase column in registers for the whole chain, laid out as the
// walk's (a warp a sample up to 7 wires, two at 8, four from 9; a lane
// bit's partner by shuffle, a warp bit's through shared memory behind the
// sample's named barrier); each thread forms only its own new row; the CZ
// signs a per-thread bit mask applied as a sign flip. No block barrier
// after the tables are staged; 1-4 samples a CTA (chain_fwd_plan in
// sim/gate_kernel.py), a plain launch.
//
// What bounds the forward on this card. At the sampling shape (w=6, B=16,
// L*k=28) the work is 168 gates of 32 pairs a sample (~1 MFLOP a launch)
// and ~16 KB: well under a microsecond at the card's peaks. The gates run
// in a row, each needing the last one's state, so a gate's latency (its
// 2x2 arithmetic and, on a lane bit, 2 shuffles an amplitude) sets the
// time. Tensor cores, TMA and wgmma do not fit: a few KB of 2x2 products a
// sample, latency-bound, with nothing to stream.
//
// gate_chain_bwd_regs_kernel<w> replaces qiddm_tpu/sim/pallas_gate_kernel.py::
// _bwd_kernel (entry _gate_chain_bwd, gate gradient from _plane_dg). Given
// the forward output (fr, fi) and the output cotangent (gr, gi), it walks
// the chain in reverse, l = n_layers-1 .. 0:
//   * multiply state and cotangent by signs[l % k] (CZ is self-inverse);
//   * for j = w-1 .. 0: the adjoint gate turns the state into the gate's
//     input; dg[l, j] pairs the output-side cotangent with that input state,
//     dg[x, y] = (sum c_x.r s_y.r + c_x.i s_y.i, sum c_x.i s_y.r - c_x.r s_y.i)
//     over rows whose wire bit is x (cotangent) and y (state), summed over
//     the batch; then the adjoint gate carries the cotangent to the gate's
//     input;
//   * at l % k == 0, undo the phase on the state and the cotangent and add
//     the phase gradient to (dpr, dpi).
// No per-layer state is stored: the states are rebuilt through inverse
// gates, as on the TPU.
//
// Backward design (chain_regs.cuh): a template on the width; state,
// cotangent, phase column and its gradient in registers, a warp a sample
// up to 7 wires (two at 8, four from 9), lane-bit partners by shuffle, dg
// partials through a per-sample shared-memory strip summed once a layer,
// 1-4 samples a CTA and the batch sum of dg at the end of the launch over a
// thread-block cluster (chain_bwd_plan in sim/gate_kernel.py). No block
// barrier a gate.
//
// What bounds the backward on this card. At the training shape (w=6, B=10,
// L*k=28) the work is ~2x the forward's pair updates plus 8 products per
// pair per gate (~5 MFLOP): ~1,000x below the float32 peak's time, and the
// bytes are ~30 KB. The 168 gates run in a row, so a gate's latency sets
// the time: its 2x2 arithmetic on 2 amplitudes a lane, 4 shuffles an
// amplitude on a lane bit, 2 strip stores (chain_regs.cuh's notes).
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"
#include "chain_regs.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(WalkShape<W>::MAX_THREADS)
    gate_chain_fwd_regs_kernel(const float* __restrict__ pr,
                               const float* __restrict__ pi,
                               const float* __restrict__ g8,
                               const float* __restrict__ signs,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i, int batch,
                               int n_layers, int k) {
  chain_fwd<W, false>(pr, pi, g8, signs, out_r, out_i, batch, n_layers, k);
}

template <int W>
__global__ void __launch_bounds__(WalkShape<W>::MAX_THREADS)
    gate_chain_bwd_regs_kernel(const float* __restrict__ pr,
                               const float* __restrict__ pi,
                               const float* __restrict__ g8,
                               const float* __restrict__ signs,
                               const float* __restrict__ fr,
                               const float* __restrict__ fi,
                               const float* __restrict__ gr,
                               const float* __restrict__ gi,
                               float* __restrict__ dg_out,
                               float* __restrict__ dpr,
                               float* __restrict__ dpi, int batch,
                               int n_layers, int k) {
  adjoint_walk<W, false>(pr, pi, g8, signs, fr, fi, gr, gi, dg_out, dpr, dpi,
                         batch, n_layers, k);
}

}  // namespace

extern "C" {

// Shared-memory bytes one forward CTA of `samples` samples needs; the
// wrapper checks it against the card's per-block limit before launching.
size_t gate_chain_fwd_smem_bytes(int wires, int n_layers, int k,
                                 int samples) {
  return fwd_layout(wires, n_layers, k, samples, false).floats *
         sizeof(float);
}

// pr, pi, out_r, out_i are (d, batch). The plan (samples a CTA, CTAs) is
// chain_fwd_plan's.
int gate_chain_fwd(const void* pr, const void* pi, const void* g8,
                   const void* signs, void* out_r, void* out_i, int wires,
                   int batch, int n_layers, int k, int samples, int grid,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fwd_plan_ok(wires, batch, samples, grid) || k < 1 || n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gate_chain_fwd_smem_bytes(wires, n_layers, k, samples);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(pr);
  const auto* c = static_cast<const float*>(pi);
  const auto* g = static_cast<const float*>(g8);
  const auto* sg = static_cast<const float*>(signs);
  auto* yr = static_cast<float*>(out_r);
  auto* yi = static_cast<float*>(out_i);
  switch (wires) {
#define FWD_CASE(W)                                                         \
  case W:                                                                   \
    err = launch_fwd(gate_chain_fwd_regs_kernel<W>, WalkShape<W>::T,        \
                     samples, grid, smem, s, a, c, g, sg, yr, yi, batch,    \
                     n_layers, k);                                          \
    break;
    FWD_CASE(1) FWD_CASE(2) FWD_CASE(3) FWD_CASE(4) FWD_CASE(5)
    FWD_CASE(6) FWD_CASE(7) FWD_CASE(8) FWD_CASE(9) FWD_CASE(10)
#undef FWD_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Shared-memory bytes one backward CTA of `samples` samples needs.
size_t gate_chain_bwd_smem_bytes(int wires, int n_layers, int k,
                                 int samples) {
  return walk_layout(wires, n_layers, k, samples, false).floats *
         sizeof(float);
}

// dg is (n_layers, wires, 8); dpr, dpi are (d, batch). The plan (samples a
// CTA, CTAs a cluster, clusters) is chain_bwd_plan's; with one cluster dg is
// summed in the launch and dg_part is unused (it may be dg), else each
// cluster's sum goes to dg_part (clusters, n_layers, wires, 8) and a second
// launch adds them in cluster order.
int gate_chain_bwd(const void* pr, const void* pi, const void* g8,
                   const void* signs, const void* fr, const void* fi,
                   const void* gr, const void* gi, void* dg_part, void* dg,
                   void* dpr, void* dpi, int wires, int batch, int n_layers,
                   int k, int samples, int cluster, int clusters, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!walk_plan_ok(wires, batch, samples, cluster, clusters) || k < 1 ||
      n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gate_chain_bwd_smem_bytes(wires, n_layers, k, samples);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(clusters == 1 ? dg : dg_part);
  const auto* a = static_cast<const float*>(pr);
  const auto* b = static_cast<const float*>(pi);
  const auto* g = static_cast<const float*>(g8);
  const auto* sg = static_cast<const float*>(signs);
  const auto* xr = static_cast<const float*>(fr);
  const auto* xi = static_cast<const float*>(fi);
  const auto* yr = static_cast<const float*>(gr);
  const auto* yi = static_cast<const float*>(gi);
  auto* ga = static_cast<float*>(dpr);
  auto* gb = static_cast<float*>(dpi);
  switch (wires) {
#define WALK_CASE(W)                                                       \
  case W:                                                                  \
    err = launch_walk(gate_chain_bwd_regs_kernel<W>, WalkShape<W>::T,      \
                      samples, cluster, clusters, smem, s, a, b, g, sg, xr, \
                      xi, yr, yi, out, ga, gb, batch, n_layers, k);        \
    break;
    WALK_CASE(1) WALK_CASE(2) WALK_CASE(3) WALK_CASE(4) WALK_CASE(5)
    WALK_CASE(6) WALK_CASE(7) WALK_CASE(8) WALK_CASE(9) WALK_CASE(10)
#undef WALK_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  return static_cast<int>(launch_dg_batch_sum(
      static_cast<const float*>(dg_part), static_cast<float*>(dg),
      n_layers * wires * 8, clusters, s));
}

const char* gate_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
