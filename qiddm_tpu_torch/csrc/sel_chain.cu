// SEL chain (StronglyEntanglingLayers on arbitrary start states), forward
// pass and its adjoint backward, for NVIDIA Hopper (sm_90a).
//
// sel_chain_fwd_kernel replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_sel_fwd_kernel (entry
// sel_chain_pallas -> _sel_chain_fwd_call). For every sample b it starts
// from the sample's own state column (sr0, si0)[:, b] and runs `depth`
// layers:
//   * a 2x2 complex gate on each wire j = 0..w-1 (as in gate_chain.cu);
//   * the layer's ring of range q + 1, q = l % (w-1), cycling over the full
//     depth (not per block of k layers as in gate_chain.cu); none at w = 1.
//     A CZ ring multiplies by the sign plane ring[q]. A CNOT ring is a basis
//     permutation: one gather new[i] = old[ring[q][i]] into a second buffer,
//     instead of w sequential CNOTs.
// The ring tables come from the wrapper (qiddm_tpu_torch/sim/sel_kernel.py),
// built from the ported cz_ring_signs and cnot_ring_perm: (p, d) 32-bit
// words, p = max(w-1, 1), float signs for CZ and int32 rows for CNOT.
//
// sel_chain_bwd_kernel replaces _sel_bwd_kernel (entry _sel_chain_bwd).
// From the forward output (fr, fi) and its cotangent (gr, gi) it walks the
// chain in reverse, l = depth-1 .. 0:
//   * the inverse ring on the state and on the cotangent: the same signs for
//     CZ (self-inverse); for CNOT the inverse permutation, a gather through
//     the forward map f (the wrapper passes f, not the forward's table);
//   * for j = w-1 .. 0 the adjoint step of chain_common.cuh: the gate's
//     input state, dg[l, j], and the cotangent carried to the gate's input.
// The cotangent left at the start is (dsr, dsi). No per-layer state is
// stored: states are rebuilt through inverse gates and rings, as on the TPU.
//
// Design. One thread block per sample with min(max(d/2, 32), 1024) threads,
// a thread per amplitude pair per gate up to 11 wires and two at 12, a
// barrier between gates, as gate_chain.cu. The state (and for the backward
// the cotangent), a second buffer of each for the CNOT gather and all
// depth*w*8 gate scalars sit in shared memory for the whole chain: at w=12,
// depth 14, 70 KB forward and 135 KB backward. The p ring tables stay in
// device memory, read through L2 (p*d*4 bytes, 180 KB at w=12, shared by
// every block): in shared memory they alone would take 180 KB at w=12 and
// push the backward past the 227 KB a block may have. dg: each block's
// partials go to a (B, depth, w, 8) workspace that dg_batch_sum_kernel sums
// over b in a fixed order, so two calls give the same bits.
//
// What bounds it on this card. At QNN's shape (w=8, depth 14, B=10) a
// forward is 14*8*128*10 pair updates (~143k, ~2 MFLOP): neither FLOPs nor
// bandwidth matter. Launch latency and the chain of block-wide barriers
// (~126 forward, ~126 backward) do, and only B of the 132 SMs get a block.
// Reading a column of a (d, B) plane with stride B is uncoalesced; at these
// sizes it is accepted.
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
//     order as sel_chain_fwd_kernel (so the same bits);
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

namespace {

__global__ void __launch_bounds__(1024)
    sel_chain_fwd_kernel(const float* __restrict__ sr0,
                         const float* __restrict__ si0,
                         const float* __restrict__ g8,
                         const unsigned* __restrict__ ring,
                         float* __restrict__ out_r,
                         float* __restrict__ out_i, int wires,
                         int batch, int depth, int is_cz) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* sr = smem;            // state, real
  float* si = sr + d;          // state, imaginary
  float* tr = si + d;          // gather buffer, real
  float* ti = tr + d;          // gather buffer, imaginary
  float* g = ti + d;           // depth * wires * 8 gate scalars
  // the p ring tables, in device memory: CZ signs or CNOT gather rows
  const float* sg = reinterpret_cast<const float*>(ring);
  const int* rows = reinterpret_cast<const int*>(ring);

  for (int i = tid; i < d; i += nt) {
    sr[i] = sr0[static_cast<size_t>(i) * batch + b];
    si[i] = si0[static_cast<size_t>(i) * batch + b];
  }
  for (int i = tid; i < depth * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

  for (int l = 0; l < depth; ++l) {
    for (int j = 0; j < wires; ++j) {
      gate_pairs(sr, si, g + (l * wires + j) * 8, 1 << (wires - 1 - j), half);
      __syncthreads();
    }
    if (wires == 1) continue;
    const int q = l % (wires - 1);
    if (is_cz) {
      const float* sgl = sg + q * d;
      for (int i = tid; i < d; i += nt) {
        const float sign = __ldg(sgl + i);
        sr[i] *= sign;
        si[i] *= sign;
      }
    } else {
      const int* rl = rows + q * d;
      for (int i = tid; i < d; i += nt) {
        const int from = __ldg(rl + i);
        tr[i] = sr[from];
        ti[i] = si[from];
      }
      float* t = sr;  // every thread swaps alike
      sr = tr;
      tr = t;
      t = si;
      si = ti;
      ti = t;
    }
    __syncthreads();
  }

  for (int i = tid; i < d; i += nt) {
    out_r[static_cast<size_t>(i) * batch + b] = sr[i];
    out_i[static_cast<size_t>(i) * batch + b] = si[i];
  }
}

__global__ void __launch_bounds__(1024)
    sel_chain_bwd_kernel(const float* __restrict__ g8,
                         const unsigned* __restrict__ ring,
                         const float* __restrict__ fr,
                         const float* __restrict__ fi,
                         const float* __restrict__ gr,
                         const float* __restrict__ gi,
                         float* __restrict__ dg_part,
                         float* __restrict__ dsr,
                         float* __restrict__ dsi, int wires,
                         int batch, int depth, int is_cz) {
  extern __shared__ float smem[];
  const int d = 1 << wires;
  const int half = d >> 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  float* sr = smem;            // state, real
  float* si = sr + d;          // state, imaginary
  float* cr = si + d;          // cotangent, real
  float* ci = cr + d;          // cotangent, imaginary
  float* tsr = ci + d;         // gather buffers of the four
  float* tsi = tsr + d;
  float* tcr = tsi + d;
  float* tci = tcr + d;
  float* g = tci + d;          // depth * wires * 8 gate scalars
  float* red = g + depth * wires * 8;  // 2 x nwarps x 8 warp partials
  // the p inverse ring tables, in device memory: CZ signs or CNOT rows
  const float* sg = reinterpret_cast<const float*>(ring);
  const int* rows = reinterpret_cast<const int*>(ring);

  for (int i = tid; i < d; i += nt) {
    const size_t at = static_cast<size_t>(i) * batch + b;
    sr[i] = fr[at];
    si[i] = fi[at];
    cr[i] = gr[at];
    ci[i] = gi[at];
  }
  for (int i = tid; i < depth * wires * 8; i += nt) g[i] = g8[i];
  __syncthreads();

  int parity = 0;
  for (int l = depth - 1; l >= 0; --l) {
    if (wires > 1) {
      const int q = l % (wires - 1);
      if (is_cz) {
        const float* sgl = sg + q * d;
        for (int i = tid; i < d; i += nt) {
          const float sign = __ldg(sgl + i);
          sr[i] *= sign;
          si[i] *= sign;
          cr[i] *= sign;
          ci[i] *= sign;
        }
      } else {
        const int* rl = rows + q * d;
        for (int i = tid; i < d; i += nt) {
          const int from = __ldg(rl + i);
          tsr[i] = sr[from];
          tsi[i] = si[from];
          tcr[i] = cr[from];
          tci[i] = ci[from];
        }
        float* t = sr;  // every thread swaps alike
        sr = tsr;
        tsr = t;
        t = si;
        si = tsi;
        tsi = t;
        t = cr;
        cr = tcr;
        tcr = t;
        t = ci;
        ci = tci;
        tci = t;
      }
      __syncthreads();
    }
    for (int j = wires - 1; j >= 0; --j) {
      adjoint_gate_step(
          sr, si, cr, ci, g + (l * wires + j) * 8, 1 << (wires - 1 - j), half,
          red + parity * nwarps * 8,
          dg_part + (static_cast<size_t>(b) * depth + l) * wires * 8 + j * 8);
      parity ^= 1;
    }
  }

  for (int i = tid; i < d; i += nt) {
    const size_t at = static_cast<size_t>(i) * batch + b;
    dsr[at] = cr[i];
    dsi[at] = ci[i];
  }
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

// Shared-memory bytes one forward block needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t sel_chain_fwd_smem_bytes(int wires, int depth) {
  const size_t d = size_t{1} << wires;
  return (4 * d + static_cast<size_t>(depth) * wires * 8) * sizeof(float);
}

// sr0, si0, out_r, out_i are (d, batch); g8 is (depth, wires, 8); ring is
// (max(wires-1, 1), d) 32-bit words (float signs if is_cz, else int32 rows).
int sel_chain_fwd(const void* sr0, const void* si0, const void* g8,
                  const void* ring, void* out_r, void* out_i, int wires,
                  int batch, int depth, int is_cz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sel_chain_fwd_smem_bytes(wires, depth);
  err = allow_smem(sel_chain_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_chain_fwd_kernel<<<batch, threads_for(wires), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sr0), static_cast<const float*>(si0),
      static_cast<const float*>(g8), static_cast<const unsigned*>(ring),
      static_cast<float*>(out_r), static_cast<float*>(out_i), wires, batch,
      depth, is_cz);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes one backward block needs.
size_t sel_chain_bwd_smem_bytes(int wires, int depth) {
  const size_t d = size_t{1} << wires;
  const size_t nwarps = threads_for(wires) / 32;
  return (8 * d + static_cast<size_t>(depth) * wires * 8 + 2 * nwarps * 8) *
         sizeof(float);
}

// ring holds the inverse rings (CNOT: the forward map f); dg_part is
// (batch, depth, wires, 8) scratch; dg is (depth, wires, 8); fr, fi, gr, gi,
// dsr, dsi are (d, batch).
int sel_chain_bwd(const void* g8, const void* ring, const void* fr,
                  const void* fi, const void* gr, const void* gi,
                  void* dg_part, void* dg, void* dsr, void* dsi, int wires,
                  int batch, int depth, int is_cz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sel_chain_bwd_smem_bytes(wires, depth);
  err = allow_smem(sel_chain_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sel_chain_bwd_kernel<<<batch, threads_for(wires), smem, s>>>(
      static_cast<const float*>(g8), static_cast<const unsigned*>(ring),
      static_cast<const float*>(fr), static_cast<const float*>(fi),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<float*>(dg_part), static_cast<float*>(dsr),
      static_cast<float*>(dsi), wires, batch, depth, is_cz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dg_batch_sum(
      static_cast<const float*>(dg_part), static_cast<float*>(dg),
      depth * wires * 8, batch, s));
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
