// SEL chain (StronglyEntanglingLayers on arbitrary start states), forward
// pass and its adjoint backward, for NVIDIA Hopper (sm_90a).
//
// sel_chain_fwd_regs_kernel<w> replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_sel_fwd_kernel (entry
// sel_chain_pallas -> _sel_chain_fwd_call). For every sample b it starts
// from the sample's own state column (sr0, si0)[:, b] and runs `depth`
// layers:
//   * a 2x2 complex gate on each wire j = 0..w-1 (as in gate_chain.cu);
//   * the layer's ring of range q + 1, q = l % (w-1), cycling over the full
//     depth (not per block of k layers as in gate_chain.cu); none at w = 1.
//     A CZ ring multiplies by (-1)^popc(i & rotl_w(i, q + 1)). A CNOT ring
//     is a basis permutation, new[i] = old[inv(i)], instead of w sequential
//     CNOTs; inv is linear over GF(2), so the wrapper
//     (qiddm_tpu_torch/sim/sel_kernel.py) passes its (p, w) int32 columns
//     inv(1 << b), p = max(w-1, 1).
//
// sel_chain_bwd_regs_kernel<w> replaces _sel_bwd_kernel (entry
// _sel_chain_bwd). From the forward output (fr, fi) and its cotangent
// (gr, gi) it walks the chain in reverse, l = depth-1 .. 0:
//   * the inverse ring on the state and on the cotangent: the same signs for
//     CZ (self-inverse); for CNOT the gather through the forward map f
//     (f(inv(i)) = i; the wrapper passes f's columns);
//   * for j = w-1 .. 0 the adjoint gate on the state, the gate's dg (the
//     output-side cotangent against the gate's input state) and the adjoint
//     gate on the cotangent.
// The cotangent left at the start is (dsr, dsi); dg (depth, w, 8) is summed
// over the batch. No per-layer state is stored: states are rebuilt through
// inverse gates and rings, as on the TPU.
//
// Design: both kernels are chain_regs.cuh's bodies (sel_fwd, sel_walk), a
// template on the width, on the layout of the gate chains' kernels #1-#4:
// the sample's state (and, backward, its cotangent) in registers for the
// whole chain, a warp a sample up to 7 wires, 2 at 8, 4 at 9-10, 8 at 11
// and 16 at 12; a lane bit's partner by shuffle, a warp bit's through the
// sample's exchange planes behind a named barrier of its warps; each thread
// forms only its own new row, in gate_pair's fmaf order (so the planes'
// forward gives the rows kernel's bits). A CZ ring is a sign flip computed
// from each row's index, with no table; a CNOT ring goes through the
// exchange planes behind one barrier of the sample, each thread reading the
// rows of the map from the columns (staged once a CTA). The backward's dg
// partials go to a shared-memory strip summed once a layer (from 11 wires
// first over each warp's lanes), and dg's batch sum ends in the launch over
// a thread-block cluster of up to 8 CTAs; past one cluster (16 samples at 8
// wires) each cluster's sum goes to a scratch that a second, fixed-order
// launch adds: no atomics, so two calls give the same bits. The gate table
// is staged by cp.async. No block-wide barrier runs after the tables are
// staged, but the walk's closing batch sum. sel_kernel.sel_fwd_plan and
// sel_bwd_plan set the samples a CTA and the clusters, from the shape alone;
// the launchers check them (fwd_plan_ok, walk_plan_ok).
//
// What bounds them on this card. At QNN's shape (w=8, depth 14, B=10) a
// forward is 112 gates of 128 amplitude pairs a sample (~2 MFLOP a launch)
// and a backward ~3x that: ~1,000x below the float32 peak's time, and the
// bytes are ~40-80 KB. The gates run in a row, each needing the last one's
// state, so a gate's latency (its 2x2 arithmetic and one exchange) sets the
// time, with a latency-bound chain per sample. Tensor cores, TMA and wgmma do
// not fit: a chain of 2x2 complex products on at most 4,096 amplitudes a
// sample, with nothing to stream and no product large enough for a tile.
//
// sel_rows_fwd_kernel is the same forward for the trajectory route, whose
// states are (N, d) complex64 rows (sel_kernel.sel_chain_rows). At its
// shape (w=12, depth 2, N = 1,000) a call reads and writes 65.5 MB, ~20 us
// at 3.35 TB/s, and the arithmetic is ~1 MFLOP a state: the bytes bound
// it. So the kernel reads and writes each state once, as float2 runs of
// contiguous amplitudes, and keeps it in registers between:
//   * a thread holds A = 2^R amplitudes (R = min(w, 4)) whose indices
//     differ in R consecutive bits, the window, and agree in the others,
//     which the thread's rank in its state sets; T = 2^(w-R) threads a
//     state, 256 / T states a block;
//   * a layer's wires are taken R at a time, in order j = 0..w-1: the
//     window holds the group's bits and the group's gates run in
//     registers, chain_common.cuh's gate_pair on each pair in the same wire
//     order as sel_chain_fwd_regs_kernel (so the same bits);
//   * between groups the amplitudes change windows through shared memory:
//     each thread writes its A, one barrier, each reads its next A. Two
//     buffers alternate, so one barrier an exchange; a float2 of padding
//     every 16 keeps a warp's accesses free of bank conflicts in every
//     window;
//   * the CZ ring multiplies by (-1)^popc(i & rotl_w(i, r)) in registers;
//     the CNOT ring's gather new[i] = old[inv(i)] is the read side of the
//     exchange that starts the next layer (inv is linear over GF(2): the
//     XOR of the columns of i's set bits, a (p, w) table in shared memory).
// At w=12 that is 3 exchanges a layer; the first window holds the top R
// bits, so a warp loads and stores 256 contiguous bytes at a time.
// Registers: 2A floats of state. Shared memory: two buffers of 17/16 d
// float2 a state, the gates and the CNOT columns (71 KB at w=12).
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); gate_chain_error_string in gate_chain.cu names it.

#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"
#include "chain_regs.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(WalkShape<W>::MAX_THREADS)
    sel_chain_fwd_regs_kernel(const float* __restrict__ sr0,
                              const float* __restrict__ si0,
                              const float* __restrict__ g8,
                              const int* __restrict__ cols,
                              float* __restrict__ out_r,
                              float* __restrict__ out_i, int batch, int depth,
                              int is_cz) {
  sel_fwd<W>(sr0, si0, g8, cols, out_r, out_i, batch, depth, is_cz);
}

template <int W>
__global__ void __launch_bounds__(WalkShape<W>::MAX_THREADS)
    sel_chain_bwd_regs_kernel(const float* __restrict__ g8,
                              const int* __restrict__ cols,
                              const float* __restrict__ fr,
                              const float* __restrict__ fi,
                              const float* __restrict__ gr,
                              const float* __restrict__ gi,
                              float* __restrict__ dg_out,
                              float* __restrict__ dsr,
                              float* __restrict__ dsi, int batch, int depth,
                              int is_cz) {
  sel_walk<W>(g8, cols, fr, fi, gr, gi, dg_out, dsr, dsi, batch, depth,
              is_cz);
}

// ------------------------------------------------------------ rows kernel

constexpr int kRowThreads = 256;

// The basis index of a thread's amplitude h: the R bits of h at bit `lo`,
// the thread's rank t (w - R bits) around them.
template <int R>
__device__ __forceinline__ int row_index(int t, int h, int lo) {
  const int low = t & ((1 << lo) - 1);
  return ((t - low) << R) | (h << lo) | low;
}

// Where amplitude i of a state sits in its exchange buffer: a float2 of
// padding after every 16.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// The thread's amplitudes move from window `lo_from` to window `lo_to`
// through buf (this state's buffer); with `cols`, the read side gathers
// new[i] = old[inv(i)], inv linear: the XOR of inv(t's bits), once, and of
// the window's columns for h's set bits. One barrier: the caller alternates
// two buffers.
template <int R>
__device__ __forceinline__ void exchange(float2 (&a)[1 << R], float2* buf,
                                         int t, int lo_from, int lo_to,
                                         const int* cols, int wires) {
#pragma unroll
  for (int h = 0; h < (1 << R); ++h)
    buf[padded(row_index<R>(t, h, lo_from))] = a[h];
  int base = 0;
  if (cols != nullptr) {
    const int ti = row_index<R>(t, 0, lo_to);
    for (int b = 0; b < wires; ++b)
      if ((ti >> b) & 1) base ^= cols[b];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < (1 << R); ++h) {
    int i = row_index<R>(t, h, lo_to);
    if (cols != nullptr) {
      i = base;
#pragma unroll
      for (int kk = 0; kk < R; ++kk)
        if ((h >> kk) & 1) i ^= cols[lo_to + kk];
    }
    a[h] = buf[padded(i)];
  }
}

template <int R>
__global__ void __launch_bounds__(kRowThreads)
    sel_rows_fwd_kernel(const float2* __restrict__ in,
                        const float* __restrict__ g8,
                        const int* __restrict__ cols,
                        float2* __restrict__ out, int wires, int n_states,
                        int depth, int is_cz) {
  constexpr int A = 1 << R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = 1 << wires;
  const int tbits = wires - R;          // bits of a thread's rank in its state
  const int per_block = blockDim.x >> tbits;
  const int t = threadIdx.x & ((1 << tbits) - 1);
  const int s = threadIdx.x >> tbits;   // the block's state of this thread
  const size_t n = static_cast<size_t>(blockIdx.x) * per_block + s;
  const bool live = n < static_cast<size_t>(n_states);
  const int stride = d + (d >> 4);
  const int p = wires > 1 ? wires - 1 : 1;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw) + s * stride;
  float2* buf1 = buf0 + per_block * stride;
  float* g = reinterpret_cast<float*>(reinterpret_cast<float2*>(smem_raw) +
                                      2 * per_block * stride);
  int* cs = reinterpret_cast<int*>(g + depth * wires * 8);
  const bool permute = !is_cz && wires > 1;

  for (int e = threadIdx.x; e < depth * wires * 8; e += blockDim.x)
    g[e] = g8[e];
  if (permute)
    for (int e = threadIdx.x; e < p * wires; e += blockDim.x) cs[e] = cols[e];
  float2 a[A];
  const float2* src = in + n * d;
#pragma unroll
  for (int h = 0; h < A; ++h)
    a[h] = live ? src[(h << tbits) | t] : make_float2(0.0f, 0.0f);
  __syncthreads();

  const int groups = (wires + R - 1) / R;
  int which = 0;  // the buffer of the next exchange
  for (int l = 0; l < depth; ++l) {
    for (int grp = 0; grp < groups; ++grp) {
      const int first = grp * R;
      const int last = min(first + R, wires);
      const int sw = min(first, wires - R);  // the window's first wire
      if (grp > 0) {
        const int lo_from = wires - R - min(first - R, wires - R);
        exchange<R>(a, which ? buf1 : buf0, t, lo_from, wires - R - sw,
                    nullptr, wires);
        which ^= 1;
      }
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        const int j = sw + kk;
        if (j < first || j >= last) continue;
        const float* m = g + (l * wires + j) * 8;
        const int bit = 1 << (R - 1 - kk);
#pragma unroll
        for (int h = 0; h < A; ++h)
          if (!(h & bit))
            gate_pair(m, a[h].x, a[h].y, a[h | bit].x, a[h | bit].y);
      }
    }
    // the last window holds the low R bits: index (t << R) | h
    if (wires > 1 && is_cz) {
      const int r = l % (wires - 1) + 1;
      const unsigned mask = static_cast<unsigned>(d - 1);
#pragma unroll
      for (int h = 0; h < A; ++h) {
        const unsigned i = static_cast<unsigned>((t << R) | h);
        const unsigned rot = ((i << r) | (i >> (wires - r))) & mask;
        if (__popc(i & rot) & 1) a[h] = make_float2(-a[h].x, -a[h].y);
      }
    }
    if (groups > 1 || permute) {
      const int* ring = permute ? cs + (l % (wires - 1)) * wires : nullptr;
      exchange<R>(a, which ? buf1 : buf0, t, 0, wires - R, ring, wires);
      which ^= 1;
    }
  }

  if (live) {
    float2* dst = out + n * d;
#pragma unroll
    for (int h = 0; h < A; ++h) dst[(h << tbits) | t] = a[h];
  }
}

// The rows kernel's launch shape for w wires and n states: the window R,
// the states a block and the threads a block.
struct RowsShape {
  int R, per_block, threads;
};

RowsShape rows_shape(int wires, int n_states) {
  RowsShape sh;
  sh.R = wires < 4 ? wires : 4;
  const int per_state = 1 << (wires - sh.R);
  const int fit = kRowThreads / per_state;
  sh.per_block = fit < n_states ? fit : (n_states > 0 ? n_states : 1);
  sh.threads = sh.per_block * per_state;
  return sh;
}

template <int R>
cudaError_t launch_rows(const RowsShape& sh, size_t smem, int blocks,
                        cudaStream_t stream, const float2* in,
                        const float* g8, const int* cols, float2* out,
                        int wires, int n_states, int depth, int is_cz) {
  cudaError_t err = allow_smem(sel_rows_fwd_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  sel_rows_fwd_kernel<R><<<blocks, sh.threads, smem, stream>>>(
      in, g8, cols, out, wires, n_states, depth, is_cz);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one forward CTA of `samples` samples needs; the
// wrapper checks it against the card's per-block limit before launching.
size_t sel_chain_fwd_smem_bytes(int wires, int depth, int samples,
                                int is_cz) {
  return sel_layout(wires, depth, samples, false, is_cz).floats *
         sizeof(float);
}

// sr0, si0, out_r, out_i are (d, batch); g8 is (depth, wires, 8); cols is
// the CNOT rings' (max(wires-1, 1), wires) int32 columns of inv (read only
// when !is_cz). The plan (samples a CTA, CTAs) is sel_fwd_plan's.
int sel_chain_fwd(const void* sr0, const void* si0, const void* g8,
                  const void* cols, void* out_r, void* out_i, int wires,
                  int batch, int depth, int is_cz, int samples, int grid,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fwd_plan_ok(wires, batch, samples, grid, 12) || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sel_chain_fwd_smem_bytes(wires, depth, samples, is_cz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(sr0);
  const auto* c = static_cast<const float*>(si0);
  const auto* g = static_cast<const float*>(g8);
  const auto* cs = static_cast<const int*>(cols);
  auto* yr = static_cast<float*>(out_r);
  auto* yi = static_cast<float*>(out_i);
  switch (wires) {
#define FWD_CASE(W)                                                          \
  case W:                                                                    \
    err = launch_fwd(sel_chain_fwd_regs_kernel<W>, WalkShape<W>::T, samples, \
                     grid, smem, s, a, c, g, cs, yr, yi, batch, depth,       \
                     is_cz);                                                 \
    break;
    FWD_CASE(1) FWD_CASE(2) FWD_CASE(3) FWD_CASE(4) FWD_CASE(5) FWD_CASE(6)
    FWD_CASE(7) FWD_CASE(8) FWD_CASE(9) FWD_CASE(10) FWD_CASE(11)
    FWD_CASE(12)
#undef FWD_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Shared-memory bytes one backward CTA of `samples` samples needs.
size_t sel_chain_bwd_smem_bytes(int wires, int depth, int samples,
                                int is_cz) {
  return sel_layout(wires, depth, samples, true, is_cz).floats *
         sizeof(float);
}

// cols holds f's columns, the forward map that undoes each CNOT ring; dg is
// (depth, wires, 8); fr, fi, gr, gi, dsr, dsi are (d, batch). The plan
// (samples a CTA, CTAs a cluster, clusters) is sel_bwd_plan's; with one
// cluster dg is summed in the launch and dg_part is unused (it may be dg),
// else each cluster's sum goes to dg_part (clusters, depth, wires, 8) and a
// second launch adds them in cluster order.
int sel_chain_bwd(const void* g8, const void* cols, const void* fr,
                  const void* fi, const void* gr, const void* gi,
                  void* dg_part, void* dg, void* dsr, void* dsi, int wires,
                  int batch, int depth, int is_cz, int samples, int cluster,
                  int clusters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!walk_plan_ok(wires, batch, samples, cluster, clusters, 12) ||
      depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sel_chain_bwd_smem_bytes(wires, depth, samples, is_cz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(clusters == 1 ? dg : dg_part);
  const auto* g = static_cast<const float*>(g8);
  const auto* cs = static_cast<const int*>(cols);
  const auto* xr = static_cast<const float*>(fr);
  const auto* xi = static_cast<const float*>(fi);
  const auto* yr = static_cast<const float*>(gr);
  const auto* yi = static_cast<const float*>(gi);
  auto* ga = static_cast<float*>(dsr);
  auto* gb = static_cast<float*>(dsi);
  switch (wires) {
#define WALK_CASE(W)                                                        \
  case W:                                                                   \
    err = launch_walk(sel_chain_bwd_regs_kernel<W>, WalkShape<W>::T,        \
                      samples, cluster, clusters, smem, s, g, cs, xr, xi,   \
                      yr, yi, out, ga, gb, batch, depth, is_cz);            \
    break;
    WALK_CASE(1) WALK_CASE(2) WALK_CASE(3) WALK_CASE(4) WALK_CASE(5)
    WALK_CASE(6) WALK_CASE(7) WALK_CASE(8) WALK_CASE(9) WALK_CASE(10)
    WALK_CASE(11) WALK_CASE(12)
#undef WALK_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || clusters == 1) return static_cast<int>(err);
  return static_cast<int>(launch_dg_batch_sum(
      static_cast<const float*>(dg_part), static_cast<float*>(dg),
      depth * wires * 8, clusters, s));
}

// Shared-memory bytes one rows block needs for n states.
size_t sel_rows_fwd_smem_bytes(int wires, int n_states, int depth) {
  const RowsShape sh = rows_shape(wires, n_states);
  const size_t d = size_t{1} << wires;
  const size_t p = wires > 1 ? wires - 1 : 1;
  return 2 * sh.per_block * (d + d / 16) * sizeof(float2) +
         static_cast<size_t>(depth) * wires * 8 * sizeof(float) +
         p * wires * sizeof(int);
}

// in and out are (n_states, d) complex64 rows (float2); g8 is
// (depth, wires, 8); cols is the CNOT rings' (max(wires-1, 1), wires)
// int32 columns of the gather map (read only when !is_cz).
int sel_rows_fwd(const void* in, const void* g8, const void* cols, void* out,
                 int wires, int n_states, int depth, int is_cz, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wires < 1 || wires > 12 || n_states < 1 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsShape sh = rows_shape(wires, n_states);
  const size_t smem = sel_rows_fwd_smem_bytes(wires, n_states, depth);
  const int blocks = (n_states + sh.per_block - 1) / sh.per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x = static_cast<const float2*>(in);
  const float* g = static_cast<const float*>(g8);
  const int* c = static_cast<const int*>(cols);
  float2* y = static_cast<float2*>(out);
  switch (sh.R) {
    case 1:
      err = launch_rows<1>(sh, smem, blocks, s, x, g, c, y, wires, n_states,
                           depth, is_cz);
      break;
    case 2:
      err = launch_rows<2>(sh, smem, blocks, s, x, g, c, y, wires, n_states,
                           depth, is_cz);
      break;
    case 3:
      err = launch_rows<3>(sh, smem, blocks, s, x, g, c, y, wires, n_states,
                           depth, is_cz);
      break;
    default:
      err = launch_rows<4>(sh, smem, blocks, s, x, g, c, y, wires, n_states,
                           depth, is_cz);
  }
  return static_cast<int>(err);
}

}  // extern "C"
