// RY-encoded re-uploading chain, forward pass and its adjoint backward, for
// NVIDIA Hopper (sm_90a).
//
// ry_chain_fwd_regs_kernel<w> replaces
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
// Design: gate_chain.cu's forward (chain_regs.cuh's chain_fwd<W, true>):
// the state in registers, a warp a sample up to 7 wires (two at 8, four
// from 9), no block barrier after the tables are staged. Each encode gate
// is a real 2x2 on both planes with the sample's (c_j, s_j), read by
// broadcast from the sample's 2w coefficients in shared memory. The TPU
// kernel's lane-broadcast (1, B) coefficient rows and its concatenation of
// dcs rows exist for Mosaic's layout and have no counterpart here.
//
// ry_chain_bwd_regs_kernel<w> replaces qiddm_tpu/sim/pallas_gate_kernel.py::
// _ry_bwd_kernel (entry _ry_chain_bwd). Given the forward output (fr, fi)
// and the output cotangent (gr, gi) it walks the chain in reverse, l =
// n_layers-1 .. 0, as gate_chain.cu's backward does (signs, then the
// adjoint step of each rotation, j = w-1 .. 0, with dg[l, j] summed over
// the batch), and at l % k == 0 un-encodes: for j = w-1 .. 0 the adjoint
// step of the encode gate, RY(-x_j), turns the state into the encode's
// input and carries the cotangent back; its dg gives the sample's encode
// gradient
//   dc_j = dg[0] + dg[6]  (g00r + g11r),  ds_j = dg[4] - dg[2]  (g10r - g01r),
// summed over the L re-uploads into dcs[j, b] and dcs[w + j, b]. These sums
// are per sample: no batch reduction.
//
// Backward design: gate_chain.cu's walk (chain_regs.cuh) with the RY
// un-encode in place of the phase: state and cotangent in registers, a
// warp a sample up to 7 wires (two at 8); each encode gate is a real 2x2
// update of a thread's pairs, and its (dc, ds) partials go through the
// sample's shared-memory strip, summed once a re-upload by thread 2j
// (dc_j) and 2j + 1 (ds_j), which carry them in a register to the end.
// dg's batch sum ends in the launch for a batch that one cluster holds; no
// atomics, so two calls give the same bits.
//
// What bounds these kernels on this card. At QIDDM_PL_noise1's shape (w=8,
// L*k=12, B=10 in training, 16 in sampling) the forward does ~120 gate
// updates of 128 amplitude pairs per sample (~2.6 MFLOP at B=10) and moves
// ~40 KB: at the card's peaks that is well under a microsecond. Its 96
// rotations and 48 encode gates run in a row, so their latency sets its
// time: at 8 wires two warps a sample, 4 amplitudes a thread, 2 of 8 wires
// on register bits, 5 on lane bits (2 shuffles an amplitude) and 1 on the
// warp bit (through shared memory, one named barrier of the sample). The
// backward's 96 rotation and 48 encode steps run in a row as well: 4
// shuffles an amplitude on a lane bit, and the sample's barriers twice a
// layer and once an exchange. Tensor cores, TMA and wgmma do not fit
// either: 2x2 products on a few KB a sample, latency-bound.
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
    ry_chain_fwd_regs_kernel(const float* __restrict__ cs,
                             const float* __restrict__ g8,
                             const float* __restrict__ signs,
                             float* __restrict__ out_r,
                             float* __restrict__ out_i, int batch,
                             int n_layers, int k) {
  chain_fwd<W, true>(cs, nullptr, g8, signs, out_r, out_i, batch, n_layers,
                     k);
}

template <int W>
__global__ void __launch_bounds__(WalkShape<W>::MAX_THREADS)
    ry_chain_bwd_regs_kernel(const float* __restrict__ cs,
                             const float* __restrict__ g8,
                             const float* __restrict__ signs,
                             const float* __restrict__ fr,
                             const float* __restrict__ fi,
                             const float* __restrict__ gr,
                             const float* __restrict__ gi,
                             float* __restrict__ dg_out,
                             float* __restrict__ dcs, int batch, int n_layers,
                             int k) {
  adjoint_walk<W, true>(cs, nullptr, g8, signs, fr, fi, gr, gi, dg_out, dcs,
                        nullptr, batch, n_layers, k);
}

}  // namespace

extern "C" {

// Shared-memory bytes one forward CTA of `samples` samples needs; the
// wrapper checks it against the card's per-block limit before launching.
size_t ry_chain_fwd_smem_bytes(int wires, int n_layers, int k, int samples) {
  return fwd_layout(wires, n_layers, k, samples, true).floats *
         sizeof(float);
}

// cs is (2 * wires, batch); out_r, out_i are (d, batch). The plan (samples
// a CTA, CTAs) is chain_fwd_plan's.
int ry_chain_fwd(const void* cs, const void* g8, const void* signs,
                 void* out_r, void* out_i, int wires, int batch, int n_layers,
                 int k, int samples, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fwd_plan_ok(wires, batch, samples, grid) || k < 1 || n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ry_chain_fwd_smem_bytes(wires, n_layers, k, samples);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cs);
  const auto* g = static_cast<const float*>(g8);
  const auto* sg = static_cast<const float*>(signs);
  auto* yr = static_cast<float*>(out_r);
  auto* yi = static_cast<float*>(out_i);
  switch (wires) {
#define FWD_CASE(W)                                                         \
  case W:                                                                   \
    err = launch_fwd(ry_chain_fwd_regs_kernel<W>, WalkShape<W>::T, samples, \
                     grid, smem, s, c, g, sg, yr, yi, batch, n_layers, k);  \
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
size_t ry_chain_bwd_smem_bytes(int wires, int n_layers, int k, int samples) {
  return walk_layout(wires, n_layers, k, samples, true).floats *
         sizeof(float);
}

// dg is (n_layers, wires, 8); dcs is (2 * wires, batch). The plan and
// dg_part as for gate_chain_bwd: with one cluster dg is summed in the
// launch, else each cluster's sum goes to dg_part (clusters, n_layers,
// wires, 8) and a second launch adds them in cluster order.
int ry_chain_bwd(const void* cs, const void* g8, const void* signs,
                 const void* fr, const void* fi, const void* gr,
                 const void* gi, void* dg_part, void* dg, void* dcs, int wires,
                 int batch, int n_layers, int k, int samples, int cluster,
                 int clusters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!walk_plan_ok(wires, batch, samples, cluster, clusters) || k < 1 ||
      n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ry_chain_bwd_smem_bytes(wires, n_layers, k, samples);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(clusters == 1 ? dg : dg_part);
  const auto* c = static_cast<const float*>(cs);
  const auto* g = static_cast<const float*>(g8);
  const auto* sg = static_cast<const float*>(signs);
  const auto* xr = static_cast<const float*>(fr);
  const auto* xi = static_cast<const float*>(fi);
  const auto* yr = static_cast<const float*>(gr);
  const auto* yi = static_cast<const float*>(gi);
  auto* ga = static_cast<float*>(dcs);
  switch (wires) {
#define WALK_CASE(W)                                                       \
  case W:                                                                  \
    err = launch_walk(ry_chain_bwd_regs_kernel<W>, WalkShape<W>::T,        \
                      samples, cluster, clusters, smem, s, c, g, sg, xr,   \
                      xi, yr, yi, out, ga, batch, n_layers, k);            \
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

}  // extern "C"
