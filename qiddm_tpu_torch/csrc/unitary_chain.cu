// Re-uploading chain that streams dense layer unitaries, forward and adjoint
// backward, for NVIDIA Hopper (sm_90a).
//
// unitary_chain_fwd_kernel replaces qiddm_tpu/sim/pallas_kernels.py::
// _fwd_kernel (entries reupload_chain_pallas, fused_reupload_chain). For
// every sample b it runs, from |0...0>, n_layers = L*k layers:
//   * at l % k == 0, multiply by the sample's phase plane (pr, pi)[:, b];
//   * s <- U_l s, with the dense complex (d, d) layer unitary U_l given as
//     real and imaginary planes (ur, ui) of shape (n_layers, d, d),
//     row-major: U_l[j, i] at (l d + j) d + i.
// d = 2^w <= 256 (the TPU kernel's MAX_FUSED_DIM). The phase and state planes
// keep the port's (d, B) float32 layout, so the kernels and their plain
// PyTorch versions take the same tensors.
//
// Forward design. Every layer is one product of U_l with the whole batch's
// state, on the tensor cores. The batch is cut into tiles of `cols` = 8 or
// 16 samples (unitary_kernel.unitary_plan picks it from the shape), and a
// tile is worked by a thread-block cluster of C = max(1, d / 16) CTAs (16
// at 8 wires, a non-portable cluster): CTA r owns rows 16 r .. 16 r + 15
// of every U_l and of the state. Each CTA keeps a whole copy of its tile's
// state, (d, cols) complex, double-buffered in shared memory, so a
// layer's product reads only local shared memory:
//   * U_l's 16 rows stream in with cp.async (16 bytes a copy) a layer
//     ahead, double-buffered: U does not depend on the state. A cluster
//     reads each U_l once, so at (8, 80, 28) the 5 clusters read the 14.7
//     MB of unitaries 5 times, where a block a sample would read it 80.
//   * The 8 warps split the product's depth d into 8 runs of 8-deep steps
//     (d < 64: one step a warp, fewer warps); each warp forms a 16 x cols
//     partial in 3xTF32 mma.sync m16n8k8 (wide_common.cuh's load_a,
//     load_b_kn, cmma_step: each large term summed from zero and added in
//     float32, as #11 does) and leaves it in shared memory; the partials
//     are summed in warp order (no atomics: the same bits every run).
//   * The sum of the CTA's 16 rows, times the sample's phase when the next
//     layer starts a block (the fold of the layer-0 phase is the start
//     state), is written into the next state buffer of every CTA of the
//     cluster through distributed shared memory, float2 stores; then one
//     cluster barrier a layer (its release and acquire order the remote
//     stores before the next layer's reads). Two buffers make one barrier
//     enough: a CTA that runs ahead writes the buffer no CTA still reads.
// Below 16 amplitudes the 16-row tile and the 8-deep step are padded with
// zero rows and columns (one CTA, one warp with work): the same code path
// at every width. The last layer writes the CTA's rows to (out_r, out_i).
//
// What bounds the forward on this card. At the route's widest block
// (w = 8, L*k = 28, B = 80) the arithmetic is 8 L k B d^2 = 1.2 GFLOP,
// three TF32 tensor-core products each (7.1 us at 495 TFLOP/s), and the
// unitaries are 14.7 MB (4.4 us at 3.35 TB/s). A layer's work is small
// (a CTA's 16 x 256 by 256 x 16 complex product is 768 mma.sync in 8
// warps), so what sets the time is the chain of 28 dependent layers: the
// product's latency, the partials' sum, the remote stores and the
// cluster barrier each layer.
//
// unitary_chain_bwd_kernel replaces qiddm_tpu/sim/pallas_kernels.py::
// _bwd_kernel (entry _fused_bwd). From the forward output (fr, fi) and its
// cotangent (gr, gi) it walks the chain in reverse, l = n_layers-1 .. 0:
//   * t = U_l^H s rebuilds the state before U_l, and n = U_l^H c pushes the
//     cotangent through it (both from one read of U_l);
//   * the state t and the output-side cotangent c of layer l go to a
//     workspace for dU_l;
//   * at l % k == 0, the phase is undone on the state and on the cotangent,
//     and its gradient added to (dpr, dpi):
//       dpr += n_r s_r + n_i s_i, dpi += n_i s_r - n_r s_i
//     with s = t conj(p) the state before the phase.
// No state is stored by the forward: the walk rebuilds them through U^H, as
// on the TPU.
//
// Backward design: the forward's units, over the same tiles of 8 or 16
// samples and the same clusters of C = max(1, d / 16) CTAs
// (unitary_kernel.unitary_bwd_plan picks the tile). CTA r owns rows 16 r ..
// 16 r + 15 of t and n, which are rows of U_l^H: the columns 16 r.. of U_l,
// conjugated. Each CTA keeps the tile's whole state and cotangent, side by
// side, double-buffered in shared memory, and each layer runs:
//   * one 3xTF32 mma.sync product of the CTA's 16 x d strip of U_l^H with
//     the d x 2N operand [s | c]: each A fragment is loaded and split once
//     and serves both halves of the walk (cmma_step over 2 N / 8 column
//     blocks; the 8 warps split the depth and sum their partials in warp
//     order, as the forward does);
//   * the strip is staged a layer ahead with cp.async, double-buffered: a
//     row of U_l gives the strip 64 contiguous bytes a plane, four 16-byte
//     copies. The strip is read column-wise into A fragments, so its rows
//     of 16 floats are swizzled (the two 32-byte halves swap on rows whose
//     bit 1 is set) and a warp's fragment loads hit 32 banks; the state
//     planes at 16 samples are swizzled alike, and the warps' partials by
//     row, so no load or store of the product is a bank conflict;
//   * the epilogue on the CUDA cores, for the CTA's 16 rows: 4 threads (8
//     at 8 samples) a (row, 4 samples) unit, each summing one of t_r, t_i,
//     n_r, n_i over the warps and trading them by shuffles; at l % k == 0
//     the phase is undone and its gradient accumulated in registers
//       dpr += n_r s_r + n_i s_i, dpi += n_i s_r - n_r s_i,
//     s = t conj(p) the state before the phase (a cluster owns its samples,
//     so no sum crosses clusters); the new s and c rows go into every CTA's
//     next buffer through distributed shared memory, a float4 a store, each
//     thread storing its one quantity; then one cluster barrier a layer.
//   * The same threads write the CTA's rows of t_l and of c_l (the
//     cotangent after U_l) to a workspace (4, n_layers, d, Bp), Bp the
//     tiles' samples: t to the first two planes, c to the last two, no row
//     twice, a float4 a store.
//
// unitary_chain_du_kernel, a helper of #14 (not counted, as #2's dg sum is
// not): dU_l = C_l T_l^H over the batch, dU_l[j, i] = sum_b c_l[j, b]
// conj(t_l[i, b]), as a 3xTF32 tensor-core product over a grid of (64 x 64
// tile of dU_l, layer l): its 8 warps own 16 x 32 of the tile each and sum
// b in increasing order in 8-deep steps (each large term summed from zero
// and added in float32, cmma_step), the samples staged 32 at a time with
// cp.async, double-buffered. No atomics: the same bits on every run. The
// workspace is 9.2 MB at w = 8, L*k = 28, B = 80.
//
// What bounds the backward on this card. Three complex products a layer
// (the state's rebuild, the cotangent's push, dU), 24 L k B d^2 = 3.5 GFLOP
// at (8, 80, 28), three TF32 products each (21 us at 495 TFLOP/s), against
// 30 MB of unitaries read and dU written (9 us at 3.35 TB/s). As in the
// forward, the chain of 28 dependent layers sets the walk's time: the
// product's latency, the partials' sum, the remote stores (twice the
// forward's: state and cotangent) and the cluster barrier each layer.
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"
#include "wide_common.cuh"  // the 3xTF32 mma.sync units and cp.async

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 256;  // MAX_FUSED_DIM

// ---------------------------------------------------------------- forward

constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kRows = 16;         // rows of U_l and of the state a CTA
constexpr int kMaxCluster = kMaxDim / kRows;

// The forward's geometry: the product's depth padded to one 8-deep step,
// the padded row strides of the staged U rows (lda = 4 mod 32: a warp's A
// fragment loads on 32 banks) and of the state (ldb = 8 or 24 mod 32: its
// B fragment loads on 32 banks), and the CTAs a cluster.
__host__ __device__ inline int fwd_depth(int d) { return d < 8 ? 8 : d; }
__host__ __device__ inline int fwd_lda(int d) { return fwd_depth(d) + 4; }
__host__ __device__ inline int fwd_ldb(int cols) { return cols | 8; }
inline int fwd_cluster(int d) { return d > kRows ? d / kRows : 1; }

// Shared memory of a forward CTA: the state [2 buffers][re, im][depth][ldb],
// U's rows [2 stages][re, im][16][lda] and the warps' partials
// [8][re, im][16][cols].
size_t fwd_smem(int d, int cols) {
  const size_t depth = fwd_depth(d);
  return (4 * depth * fwd_ldb(cols) + 4 * kRows * fwd_lda(d) +
          2 * kFwdWarps * kRows * cols) *
         sizeof(float);
}

template <int NB>
__global__ void __launch_bounds__(kFwdThreads)
    unitary_chain_fwd_kernel(const float* __restrict__ pr,
                             const float* __restrict__ pi,
                             const float* __restrict__ ur,
                             const float* __restrict__ ui,
                             float* __restrict__ out_r,
                             float* __restrict__ out_i, int d, int batch,
                             int n_layers, int k, int granule) {
  constexpr int N = 8 * NB;                 // samples a tile
  constexpr int LDB = N | 8;
  constexpr int PAIRS = kRows * N / 2;      // output pairs (r, c, c + 1)
  constexpr int SPLIT = kFwdThreads / PAIRS;  // threads a pair's stores
  static_assert(PAIRS * SPLIT == kFwdThreads, "8 or 16 samples a tile");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int depth = fwd_depth(d);
  const int lda = fwd_lda(d);
  const int row0 = rank * kRows;
  const int rows = d < kRows ? d : kRows;   // a power of two
  const int col0 = (blockIdx.x / n_cta) * N;
  const int bplane = depth * LDB;
  const int uplane = kRows * lda;
  float* st = smem;                 // [buffer][re, im][depth][LDB]
  float* us = st + 4 * bplane;      // [stage][re, im][16][lda]
  float* red = us + 4 * uplane;     // [warp][re, im][16][N]

  // rows 16 r.. of U_l into stage l & 1, `granule` floats a copy; every
  // thread commits a group, empty past the last layer
  const int row_shift = __ffs(rows) - 1;
  const int per_row_shift = __ffs(d / granule) - 1;
  auto stage_u = [&](int l) {
    if (l < n_layers) {
      const size_t at = (static_cast<size_t>(l) * d + row0) * d;
      float* dst = us + (l & 1) * 2 * uplane;
      const int copies = 2 << (row_shift + per_row_shift);
      for (int e = tid; e < copies; e += kFwdThreads) {
        const int q = e >> (row_shift + per_row_shift);  // 0: re, 1: im
        const int r = (e >> per_row_shift) & (rows - 1);
        const int c = (e & ((1 << per_row_shift) - 1)) * granule;
        cp_async(dst + q * uplane + r * lda + c,
                 (q ? ui : ur) + at + static_cast<size_t>(r) * d + c,
                 granule);
      }
    }
    cp_async_commit();
  };

  // the start state |0...0> times the layer-0 phase in buffer 0, zeros
  // elsewhere (the padding rows below 8 amplitudes stay 0); U's padding
  // rows and columns below 16 amplitudes are 0 in both stages (the copies
  // write only the rest)
  for (int e = tid; e < 4 * bplane; e += kFwdThreads) {
    const int c = e % LDB;
    const int b = col0 + c;
    const bool start = e < LDB && c < N && b < batch;  // buffer 0, row 0, re
    const bool start_i = e >= bplane && e - bplane < LDB && c < N &&
                         b < batch;                    // buffer 0, row 0, im
    st[e] = start ? pr[b] : start_i ? pi[b] : 0.0f;
  }
  if (d < kRows)
    for (int e = tid; e < 4 * uplane; e += kFwdThreads) {
      const int r = (e / lda) % kRows;
      const int c = e % lda;
      if (r >= d || c >= d) us[e] = 0.0f;
    }
  stage_u(0);
  stage_u(1);

  // this thread's output pair: row r, columns c, c + 1 of the tile; the
  // threads of a pair share its stores to the cluster's CTAs
  const int pair = tid % PAIRS;
  const int part = tid / PAIRS;
  const int pr_row = pair / (N / 2);
  const int pc = 2 * (pair % (N / 2));
  const bool live = pr_row < rows;
  float2 ph[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (live)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = col0 + pc + h;
      if (b < batch) {
        const size_t at = static_cast<size_t>(row0 + pr_row) * batch + b;
        ph[h] = make_float2(pr[at], pi[at]);
      }
    }
  // every CTA's buffers are set before any CTA writes into them
  if (n_cta > 1)
    cluster.sync();
  else
    __syncthreads();

  const int steps = depth >> 3;  // 8-deep steps of the product
  const int per_warp = steps > kFwdWarps ? steps / kFwdWarps : 1;
  const int n_warps = steps < kFwdWarps ? steps : kFwdWarps;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  for (int l = 0; l < n_layers; ++l) {
    cp_async_wait<1>();  // U_l has landed (this thread's copies)
    __syncthreads();     // and every thread's
    const float* sb = st + (l & 1) * 2 * bplane;
    const float* ua = us + (l & 1) * 2 * uplane;
    if (warp < n_warps) {
      float cr[NB][4], ci[NB][4], sr[NB][4], si[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cr[b][i] = ci[b][i] = sr[b][i] = si[b][i] = 0.0f;
      for (int s = 0; s < per_warp; ++s) {
        const int k0 = (warp * per_warp + s) * 8;
        FragA ar, ai;
        load_a(&ar, ua, lda, 0, k0, lane);
        load_a(&ai, ua + uplane, lda, 0, k0, lane);
        const FragA nai = negated(ai);
        FragB br[NB], bi[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          load_b_kn(&br[b], sb, LDB, k0, 8 * b, lane);
          load_b_kn(&bi[b], sb + bplane, LDB, k0, 8 * b, lane);
        }
        cmma_step<NB>(cr, ci, sr, si, ar, ai, nai, br, bi);
      }
      add_small<NB>(cr, sr);
      add_small<NB>(ci, si);
      // c0 (g, 2 t4), c1 (g, 2 t4 + 1), c2 (g + 8, 2 t4), c3 (g + 8, ...)
      float* wr = red + warp * 2 * kRows * N;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (g + 8 * h) * N + 8 * b + 2 * t4;
          *reinterpret_cast<float2*>(wr + at) =
              make_float2(cr[b][2 * h], cr[b][2 * h + 1]);
          *reinterpret_cast<float2*>(wr + kRows * N + at) =
              make_float2(ci[b][2 * h], ci[b][2 * h + 1]);
        }
    }
    __syncthreads();  // the partials are in; stage l & 1 is free
    stage_u(l + 2);

    if (live) {
      float2 vr = make_float2(0.0f, 0.0f), vi = vr;
      const int at = pr_row * N + pc;
      for (int w8 = 0; w8 < n_warps; ++w8) {  // in warp order
        const float2 a = *reinterpret_cast<const float2*>(
            red + w8 * 2 * kRows * N + at);
        const float2 q = *reinterpret_cast<const float2*>(
            red + (w8 * 2 + 1) * kRows * N + at);
        vr = make_float2(vr.x + a.x, vr.y + a.y);
        vi = make_float2(vi.x + q.x, vi.y + q.y);
      }
      if (l + 1 < n_layers) {
        if ((l + 1) % k == 0) {  // the next block's phase, folded in
          const float2 v0 = cmul(make_float2(vr.x, vi.x), ph[0]);
          const float2 v1 = cmul(make_float2(vr.y, vi.y), ph[1]);
          vr = make_float2(v0.x, v1.x);
          vi = make_float2(v0.y, v1.y);
        }
        float* nxt = st + ((l + 1) & 1) * 2 * bplane +
                     (row0 + pr_row) * LDB + pc;
        for (int q = part; q < n_cta; q += SPLIT) {
          float* dst = n_cta > 1 ? cluster.map_shared_rank(nxt, q) : nxt;
          *reinterpret_cast<float2*>(dst) = vr;
          *reinterpret_cast<float2*>(dst + bplane) = vi;
        }
      } else if (part == 0) {
        const int b = col0 + pc;
        const size_t o = static_cast<size_t>(row0 + pr_row) * batch + b;
        if (b < batch) {
          out_r[o] = vr.x;
          out_i[o] = vi.x;
        }
        if (b + 1 < batch) {
          out_r[o + 1] = vr.y;
          out_i[o + 1] = vi.y;
        }
      }
    }
    // the next state is whole in every CTA, and the partials are read
    if (l + 1 < n_layers) {
      if (n_cta > 1)
        cluster.sync();
      else
        __syncthreads();
    }
  }
  cp_async_wait<0>();  // nothing left in flight at exit (empty groups)
}

// ---------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;  // 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;

// The swizzle of a row of 16 floats: its two 32-byte halves swap on rows
// whose bit 1 is set. A warp's fragment loads of rows k0 + t (t = 0..3,
// and t + 4) at columns n0 + g (g = 0..7) then hit 32 banks.
__host__ __device__ inline int swz16(int row) { return ((row >> 1) & 1) << 3; }

// Where column c of row `row` of a [rows][LD] plane lives: swizzled at 16
// floats a row, as it is at 8 (8 floats a row already spread a fragment's
// loads over 32 banks).
template <int LD>
__device__ __forceinline__ int at_sw(int row, int c) {
  return row * LD + (LD == 16 ? c ^ swz16(row) : c);
}

// The A fragment of rows m = 0..15, columns k0..k0+7 of the transpose of a
// swizzled [depth][16] plane (element (m, k) at at_sw<16>(k, m)).
__device__ __forceinline__ void load_a_strip(FragA* f, const float* s,
                                             int k0, int lane) {
  const int g = lane >> 2;
  const int k = k0 + (lane & 3);
  const int x = swz16(k);  // row k + 4 swizzles alike
  const float* p = s + k * 16;
  split_tf32(p[g ^ x], &f->hi[0], &f->lo[0]);
  split_tf32(p[(g + 8) ^ x], &f->hi[1], &f->lo[1]);
  split_tf32(p[64 + (g ^ x)], &f->hi[2], &f->lo[2]);
  split_tf32(p[64 + ((g + 8) ^ x)], &f->hi[3], &f->lo[3]);
}

// The B fragment of rows k0.., columns n0..n0+7 of a [depth][LD] plane laid
// out by at_sw<LD>.
template <int LD>
__device__ __forceinline__ void load_b_sw(FragB* f, const float* s, int k0,
                                          int n0, int lane) {
  const int k = k0 + (lane & 3);
  const int n = n0 + (lane >> 2);
  split_tf32(s[at_sw<LD>(k, n)], &f->hi[0], &f->lo[0]);
  split_tf32(s[at_sw<LD>(k + 4, n)], &f->hi[1], &f->lo[1]);
}

// The warps' partials: [warp][re, im][16 rows][2 N columns], a row's
// columns swizzled by 8 (row & 3) floats at 16 samples (by 8 (row >> 1 & 1)
// at 8), so that a warp's float2 stores of its mma fragment hit 32 banks;
// the im plane starts 8 floats on at 16 samples (16 at 8), so that the
// epilogue's float4 loads of t_r, t_i, n_r and n_i (two units a quarter
// warp at 16 samples, one at 8) do too.
__host__ __device__ constexpr int red_plane(int n) {
  return kRows * 2 * n + (n == 16 ? 8 : 16);
}

template <int N>
__device__ __forceinline__ int red_at(int row, int c) {
  return row * 2 * N +
         (c ^ (N == 16 ? (row & 3) << 3 : ((row >> 1) & 1) << 3));
}

// Shared memory of a backward CTA: the state and cotangent [2 buffers][s_r,
// s_i, c_r, c_i][depth][cols], U's strip [2 stages][re, im][depth][16] and
// the warps' partials [8][re, im] of red_plane floats.
size_t bwd_smem(int d, int cols) {
  const size_t depth = fwd_depth(d);
  const size_t red = red_plane(cols);
  return (8 * depth * cols + 4 * depth * kRows + 2 * kBwdWarps * red) *
         sizeof(float);
}

template <int NB>
__global__ void __launch_bounds__(kBwdThreads)
    unitary_chain_bwd_kernel(const float* __restrict__ pr,
                             const float* __restrict__ pi,
                             const float* __restrict__ ur,
                             const float* __restrict__ ui,
                             const float* __restrict__ fr,
                             const float* __restrict__ fi,
                             const float* __restrict__ gr,
                             const float* __restrict__ gi,
                             float* __restrict__ ws,
                             float* __restrict__ dpr,
                             float* __restrict__ dpi, int d, int batch,
                             int n_layers, int k, int granule) {
  constexpr int N = 8 * NB;         // samples a tile
  constexpr int M = 2 * NB;         // 8-column blocks of [s | c]
  constexpr int QUADS = N / 4;      // 4-sample groups of a row
  constexpr int SPLIT = kBwdThreads / (kRows * QUADS);  // threads a unit
  constexpr int HALVES = SPLIT / 4;  // ways the remote stores are split
  constexpr int RED = red_plane(N);
  static_assert(SPLIT == 4 || SPLIT == 8, "8 or 16 samples a tile");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int depth = fwd_depth(d);
  const int row0 = rank * kRows;
  const int rows = d < kRows ? d : kRows;  // a power of two
  const int col0 = (blockIdx.x / n_cta) * N;
  const int bp = gridDim.x / n_cta * N;    // the workspace's samples
  const int bplane = depth * N;
  const int uplane = depth * kRows;
  float* st = smem;                 // [buffer][s_r, s_i, c_r, c_i][depth][N]
  float* us = st + 8 * bplane;      // [stage][re, im][depth][16]
  float* red = us + 4 * uplane;     // [warp][re, im] of RED floats
  const size_t wsp = static_cast<size_t>(n_layers) * d * bp;

  // walk step g (layer n_layers - 1 - g): columns row0.. of every row of
  // U_l into stage g & 1, `granule` floats a copy; every thread commits a
  // group, empty past the last layer
  const int d_shift = __ffs(d) - 1;
  const int per_row_shift = __ffs(rows / granule) - 1;
  auto stage_u = [&](int g) {
    if (g < n_layers) {
      const size_t at =
          static_cast<size_t>(n_layers - 1 - g) * d * d + row0;
      float* dst = us + (g & 1) * 2 * uplane;
      const int copies = 2 << (d_shift + per_row_shift);
      for (int e = tid; e < copies; e += kBwdThreads) {
        const int q = e >> (d_shift + per_row_shift);  // 0: re, 1: im
        const int j = (e >> per_row_shift) & (d - 1);
        const int c = (e & ((1 << per_row_shift) - 1)) * granule;
        cp_async(dst + q * uplane + at_sw<kRows>(j, c),
                 (q ? ui : ur) + at + static_cast<size_t>(j) * d + c,
                 granule);
      }
    }
    cp_async_commit();
  };

  // the output f and its cotangent g in buffer 0, zeros in buffer 1 and in
  // the padding (rows past d below 8 amplitudes, samples past the batch);
  // U's padding rows and columns below 16 amplitudes are 0 in both stages
  // (the copies write only the rest)
  for (int e = tid; e < 8 * bplane; e += kBwdThreads) {
    const int q = e / bplane;  // buffer 1 from q = 4
    const int j = (e - q * bplane) / N;
    const int x = e % N;
    const int b = col0 + (N == 16 ? x ^ swz16(j) : x);
    float v = 0.0f;
    if (q < 4 && j < d && b < batch) {
      const float* src = q == 0 ? fr : q == 1 ? fi : q == 2 ? gr : gi;
      v = src[static_cast<size_t>(j) * batch + b];
    }
    st[e] = v;
  }
  if (d < kRows)
    for (int e = tid; e < 4 * uplane; e += kBwdThreads) {
      const int j = (e / kRows) % depth;
      const int c = (e % kRows) ^ swz16(j);
      if (j >= d || c >= rows) us[e] = 0.0f;
    }
  stage_u(0);
  stage_u(1);

  // this thread's unit: row `urow`, samples c4 .. c4 + 3 of the tile; its
  // quantity qty (0 t_r, 1 t_i, 2 n_r, 3 n_i; the stores: s_r, s_i, c_r,
  // c_i), and its share `half` of the remote stores
  const int unit = tid / SPLIT;
  const int part = tid % SPLIT;
  const int qty = part & 3;
  const int half = part >> 2;
  const int urow = unit / QUADS;
  const int c4 = 4 * (unit % QUADS);
  const bool live = urow < rows;
  float ph_r[4], ph_i[4], dp_r[4], dp_i[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int b = col0 + c4 + h;
    const bool in = live && b < batch;
    const size_t at = static_cast<size_t>(row0 + urow) * batch + b;
    ph_r[h] = in ? pr[at] : 0.0f;
    ph_i[h] = in ? pi[at] : 0.0f;
    dp_r[h] = dp_i[h] = 0.0f;
  }
  // every CTA's buffers are set before any CTA writes into them
  if (n_cta > 1)
    cluster.sync();
  else
    __syncthreads();

  const int steps = depth >> 3;  // 8-deep steps of the product
  const int per_warp = steps > kBwdWarps ? steps / kBwdWarps : 1;
  const int n_warps = steps < kBwdWarps ? steps : kBwdWarps;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int src_lane = lane - qty;  // this unit's lane of quantity 0
  for (int g = 0; g < n_layers; ++g) {
    const int l = n_layers - 1 - g;
    cp_async_wait<1>();  // the strip of U_l has landed (this thread's)
    __syncthreads();     // and every thread's
    const float* sb = st + (g & 1) * 4 * bplane;
    const float* ua = us + (g & 1) * 2 * uplane;
    if (warp < n_warps) {
      float cr[M][4], ci[M][4], sr[M][4], si[M][4];
#pragma unroll
      for (int b = 0; b < M; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cr[b][i] = ci[b][i] = sr[b][i] = si[b][i] = 0.0f;
      for (int s = 0; s < per_warp; ++s) {
        const int k0 = (warp * per_warp + s) * 8;
        // U_l^H = ur^T - i ui^T: ai = -(ui^T), nai = ui^T
        FragA ar, nai;
        load_a_strip(&ar, ua, k0, lane);
        load_a_strip(&nai, ua + uplane, k0, lane);
        const FragA ai = negated(nai);
        FragB br[M], bi[M];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          load_b_sw<N>(&br[b], sb, k0, 8 * b, lane);
          load_b_sw<N>(&bi[b], sb + bplane, k0, 8 * b, lane);
          load_b_sw<N>(&br[NB + b], sb + 2 * bplane, k0, 8 * b, lane);
          load_b_sw<N>(&bi[NB + b], sb + 3 * bplane, k0, 8 * b, lane);
        }
        cmma_step<M>(cr, ci, sr, si, ar, ai, nai, br, bi);
      }
      add_small<M>(cr, sr);
      add_small<M>(ci, si);
      // c0 (g, 2 t4), c1 (g, 2 t4 + 1), c2 (g + 8, 2 t4), c3 (g + 8, ...)
      float* wr = red + warp * 2 * RED;
#pragma unroll
      for (int b = 0; b < M; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = red_at<N>(g8 + 8 * h, 8 * b + 2 * t4);
          *reinterpret_cast<float2*>(wr + at) =
              make_float2(cr[b][2 * h], cr[b][2 * h + 1]);
          *reinterpret_cast<float2*>(wr + RED + at) =
              make_float2(ci[b][2 * h], ci[b][2 * h + 1]);
        }
    }
    __syncthreads();  // the partials are in; stage g & 1 is free
    stage_u(g + 2);

    // this thread's quantity summed over the warps, in warp order
    const float* rq = red + (qty & 1) * RED +
                      red_at<N>(urow, c4 + (qty >> 1) * N);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live)
      for (int w8 = 0; w8 < n_warps; ++w8) {
        const float4 a = *reinterpret_cast<const float4*>(rq + w8 * 2 * RED);
        v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
      }
    // the unit's four quantities from its lanes (the whole warp takes
    // part): t_r, t_i, n_r, n_i
    float4 q4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      q4[q] = make_float4(__shfl_sync(0xffffffffu, v.x, src_lane + q),
                          __shfl_sync(0xffffffffu, v.y, src_lane + q),
                          __shfl_sync(0xffffffffu, v.z, src_lane + q),
                          __shfl_sync(0xffffffffu, v.w, src_lane + q));
    if (live) {
      const int at = at_sw<N>(row0 + urow, c4);
      if (half == 0)  // t_l and the cotangent after U_l, for dU_l
        *reinterpret_cast<float4*>(
            ws + qty * wsp +
            (static_cast<size_t>(l) * d + row0 + urow) * bp + col0 + c4) =
            qty < 2 ? v
                    : *reinterpret_cast<const float4*>(sb + qty * bplane +
                                                       at);
      // the state before U_l and the cotangent pushed through it (s_r,
      // s_i, c_r, c_i), of which this thread stores its quantity
      float o[4][4];
      const float tr[4] = {q4[0].x, q4[0].y, q4[0].z, q4[0].w};
      const float ti[4] = {q4[1].x, q4[1].y, q4[1].z, q4[1].w};
      const float nr[4] = {q4[2].x, q4[2].y, q4[2].z, q4[2].w};
      const float ni[4] = {q4[3].x, q4[3].y, q4[3].z, q4[3].w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (l % k == 0) {  // undo the phase; its gradient
          const float p = ph_r[h], q = ph_i[h];
          const float sr = tr[h] * p + ti[h] * q;  // the state before it
          const float si = ti[h] * p - tr[h] * q;
          dp_r[h] = dp_r[h] + nr[h] * sr + ni[h] * si;
          dp_i[h] = dp_i[h] + ni[h] * sr - nr[h] * si;
          o[0][h] = sr;
          o[1][h] = si;
          o[2][h] = nr[h] * p + ni[h] * q;
          o[3][h] = ni[h] * p - nr[h] * q;
        } else {
          o[0][h] = tr[h];
          o[1][h] = ti[h];
          o[2][h] = nr[h];
          o[3][h] = ni[h];
        }
      }
      float mine[4];  // selected, not indexed: the arrays stay in registers
#pragma unroll
      for (int h = 0; h < 4; ++h)
        mine[h] = qty == 0   ? o[0][h]
                  : qty == 1 ? o[1][h]
                  : qty == 2 ? o[2][h]
                             : o[3][h];
      if (l > 0) {
        float* nxt = st + ((g + 1) & 1) * 4 * bplane + qty * bplane + at;
        const float4 val = make_float4(mine[0], mine[1], mine[2], mine[3]);
        for (int r = half; r < n_cta; r += HALVES) {
          float* dst = n_cta > 1 ? cluster.map_shared_rank(nxt, r) : nxt;
          *reinterpret_cast<float4*>(dst) = val;
        }
      } else if (half == 0 && qty < 2) {
        float* out = qty == 0 ? dpr : dpi;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int b = col0 + c4 + h;
          if (b < batch)
            out[static_cast<size_t>(row0 + urow) * batch + b] =
                qty == 0 ? dp_r[h] : dp_i[h];
        }
      }
    }
    // the next state is whole in every CTA, and the partials are read
    if (l > 0) {
      if (n_cta > 1)
        cluster.sync();
      else
        __syncthreads();
    }
  }
  cp_async_wait<0>();  // nothing left in flight at exit (empty groups)
}

constexpr int kDuTile = 64;      // rows j and columns i of dU_l a block
constexpr int kDuK = 32;         // samples a staged chunk
constexpr int kDuLd = kDuK + 4;  // its row stride: 4 mod 32, so the
                                 // fragment loads (g ld + t) hit 32 banks

size_t du_smem() {
  return 2 * 4 * static_cast<size_t>(kDuTile) * kDuLd * sizeof(float);
}

// dU_l's (64 x 64) tile (j0.., i0..) of layer blockIdx.z: warp w owns rows
// 16 (w & 3).. and columns 32 (w >> 2).. of it. Rows past d are never
// staged: they feed only outputs past d, which are not stored.
__global__ void __launch_bounds__(kBwdThreads)
    unitary_chain_du_kernel(const float* __restrict__ ws,
                            float* __restrict__ dur, float* __restrict__ dui,
                            int d, int bp, int n_layers) {
  extern __shared__ __align__(16) float smem[];  // [stage][t_r, t_i, c_r,
                                                 // c_i][64][kDuLd]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * kDuTile;
  const int j0 = blockIdx.y * kDuTile;
  const int l = blockIdx.z;
  const int plane = kDuTile * kDuLd;
  const size_t wsp = static_cast<size_t>(n_layers) * d * bp;
  const size_t at = static_cast<size_t>(l) * d * bp;
  const int chunks = (bp + kDuK - 1) / kDuK;

  // samples 32 c.. of the tile's rows of t (i) and c (j) into stage c & 1,
  // 16 bytes a copy (bp and the chunks are multiples of 8 samples)
  auto stage = [&](int c) {
    if (c < chunks) {
      const int b0 = c * kDuK;
      const int per = (bp - b0 < kDuK ? bp - b0 : kDuK) / 4;
      float* dst = smem + (c & 1) * 4 * plane;
      for (int e = tid; e < 4 * kDuTile * per; e += kBwdThreads) {
        const int q = e / (kDuTile * per);
        const int r = (e / per) % kDuTile;
        const int x = (e % per) * 4;
        const int row = (q < 2 ? i0 : j0) + r;
        if (row < d)
          cp_async(dst + q * plane + r * kDuLd + x,
                   ws + q * wsp + at + static_cast<size_t>(row) * bp + b0 + x,
                   4);
      }
    }
    cp_async_commit();
  };

  const int m0 = 16 * (warp & 3);
  const int n0 = 32 * (warp >> 2);
  const bool work = j0 + m0 < d && i0 + n0 < d;
  float cr[4][4], ci[4][4], sr[4][4], si[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) cr[b][i] = ci[b][i] = sr[b][i] = si[b][i] = 0.0f;
  stage(0);
  stage(1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    const float* s = smem + (c & 1) * 4 * plane;
    const int kc = bp - c * kDuK < kDuK ? bp - c * kDuK : kDuK;
    if (work)
      for (int k0 = 0; k0 < kc; k0 += 8) {  // b in increasing order
        // C_l (j, b) against T_l^H (b, i) = t_r - i t_i
        FragA ar, ai;
        load_a(&ar, s + 2 * plane, kDuLd, m0, k0, lane);
        load_a(&ai, s + 3 * plane, kDuLd, m0, k0, lane);
        const FragA nai = negated(ai);
        FragB br[4], bi[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          FragB t;
          load_b_nk(&br[n], s, kDuLd, k0, n0 + 8 * n, lane);
          load_b_nk(&t, s + plane, kDuLd, k0, n0 + 8 * n, lane);
          bi[n] = negated(t);
        }
        cmma_step<4>(cr, ci, sr, si, ar, ai, nai, br, bi);
      }
    __syncthreads();  // stage c & 1 is read before chunk c + 2 lands
    stage(c + 2);
  }
  cp_async_wait<0>();
  if (!work) return;
  add_small<4>(cr, sr);
  add_small<4>(ci, si);
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + m0 + g + 8 * h;
      const int i = i0 + n0 + 8 * n + 2 * t4;
      if (j < d && i < d) {  // d is even: i + 1 < d too
        const size_t o = (static_cast<size_t>(l) * d + j) * d + i;
        *reinterpret_cast<float2*>(dur + o) =
            make_float2(cr[n][2 * h], cr[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dui + o) =
            make_float2(ci[n][2 * h], ci[n][2 * h + 1]);
      }
    }
}

// Sets a cluster kernel's attributes (smem bytes a CTA, the non-portable
// cluster of 16 CTAs) and fills cfg for `tiles` tiles of samples, each a
// cluster of fwd_cluster(d) CTAs of `threads`; attr (one entry) must
// outlive cfg.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int threads, int d,
                           int tiles, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  const int cluster = fwd_cluster(d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(tiles * cluster);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// The forward's configuration for a tile of 8 NB samples and `batch`
// samples: ceil(batch / (8 NB)) clusters.
template <int NB>
cudaError_t fwd_config(int d, int batch, cudaStream_t stream,
                       cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  return cluster_config(unitary_chain_fwd_kernel<NB>, fwd_smem(d, 8 * NB),
                        kFwdThreads, d, (batch + 8 * NB - 1) / (8 * NB),
                        stream, attr, cfg);
}

// The backward's, alike.
template <int NB>
cudaError_t bwd_config(int d, int batch, cudaStream_t stream,
                       cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  return cluster_config(unitary_chain_bwd_kernel<NB>, bwd_smem(d, 8 * NB),
                        kBwdThreads, d, (batch + 8 * NB - 1) / (8 * NB),
                        stream, attr, cfg);
}

// How many of the forward's clusters the card holds at once (0: none).
template <int NB>
cudaError_t fwd_active(int d, int* clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = fwd_config<NB>(d, 1, nullptr, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters,
                                        unitary_chain_fwd_kernel<NB>, &cfg);
}

// And of the backward's.
template <int NB>
cudaError_t bwd_active(int d, int* clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = bwd_config<NB>(d, 1, nullptr, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters,
                                        unitary_chain_bwd_kernel<NB>, &cfg);
}

template <int NB>
cudaError_t launch_fwd(const float* pr, const float* pi, const float* ur,
                       const float* ui, float* out_r, float* out_i, int d,
                       int batch, int n_layers, int k, cudaStream_t s) {
  int clusters = 0;
  cudaError_t err = fwd_active<NB>(d, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = fwd_config<NB>(d, batch, s, &attr, &cfg);
  if (err != cudaSuccess) return err;
  const int granule =
      aligned16({pr, pi, ur, ui}) ? (d < 4 ? d : 4) : 1;
  err = cudaLaunchKernelEx(&cfg, unitary_chain_fwd_kernel<NB>, pr, pi, ur,
                           ui, out_r, out_i, d, batch, n_layers, k, granule);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The walk, then dU_l's product: two launches on the stream.
template <int NB>
cudaError_t launch_bwd(const float* pr, const float* pi, const float* ur,
                       const float* ui, const float* fr, const float* fi,
                       const float* gr, const float* gi, float* ws,
                       float* dur, float* dui, float* dpr, float* dpi,
                       int d, int batch, int n_layers, int k,
                       cudaStream_t s) {
  int clusters = 0;
  cudaError_t err = bwd_active<NB>(d, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = bwd_config<NB>(d, batch, s, &attr, &cfg);
  if (err != cudaSuccess) return err;
  const int rows = d < kRows ? d : kRows;
  const int granule = aligned16({ur, ui}) ? (rows < 4 ? rows : 4) : 1;
  err = cudaLaunchKernelEx(&cfg, unitary_chain_bwd_kernel<NB>, pr, pi, ur,
                           ui, fr, fi, gr, gi, ws, dpr, dpi, d, batch,
                           n_layers, k, granule);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem(unitary_chain_du_kernel, du_smem());
  if (err != cudaSuccess) return err;
  const int tiles = (d + kDuTile - 1) / kDuTile;
  const int bp = (batch + 8 * NB - 1) / (8 * NB) * (8 * NB);
  unitary_chain_du_kernel<<<dim3(tiles, tiles, n_layers), kBwdThreads,
                            du_smem(), s>>>(ws, dur, dui, d, bp, n_layers);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a forward CTA needs at a tile of `cols` samples, and
// a backward CTA at a tile of `cols`; the wrapper checks them against its
// plan and the card's per-block limit.
size_t unitary_chain_fwd_smem_bytes(int wires, int cols) {
  return fwd_smem(1 << wires, cols);
}

size_t unitary_chain_bwd_smem_bytes(int wires, int cols) {
  return bwd_smem(1 << wires, cols);
}

// How many forward (backward) clusters, fwd_cluster(d) CTAs each, the card
// holds at once at a tile of `cols` samples (0: none, and the launch is
// refused; a negative cudaError on failure); chip_smoke.py prints it with
// the plan.
int unitary_chain_fwd_active_clusters(int wires, int cols, int device) {
  cudaError_t err = cudaSetDevice(device);
  const int d = 1 << wires;
  if (err == cudaSuccess && (d > kMaxDim || (cols != 8 && cols != 16)))
    err = cudaErrorInvalidValue;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cols == 8 ? fwd_active<1>(d, &clusters)
                    : fwd_active<2>(d, &clusters);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

int unitary_chain_bwd_active_clusters(int wires, int cols, int device) {
  cudaError_t err = cudaSetDevice(device);
  const int d = 1 << wires;
  if (err == cudaSuccess && (d > kMaxDim || (cols != 8 && cols != 16)))
    err = cudaErrorInvalidValue;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cols == 8 ? bwd_active<1>(d, &clusters)
                    : bwd_active<2>(d, &clusters);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

// pr, pi, out_r, out_i are (d, batch); ur, ui are (n_layers, d, d); cols
// (8 or 16) samples a tile, each tile a cluster of max(1, d / 16) CTAs.
int unitary_chain_fwd(const void* pr, const void* pi, const void* ur,
                      const void* ui, void* out_r, void* out_i, int wires,
                      int batch, int n_layers, int k, int cols, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 1 << wires;
  if (d > kMaxDim || fwd_cluster(d) > kMaxCluster || batch < 1 ||
      n_layers < 1 || k < 1 || (cols != 8 && cols != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(pr);
  const auto* b = static_cast<const float*>(pi);
  const auto* u = static_cast<const float*>(ur);
  const auto* v = static_cast<const float*>(ui);
  auto* o = static_cast<float*>(out_r);
  auto* p = static_cast<float*>(out_i);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cols == 8 ? launch_fwd<1>(a, b, u, v, o, p, d, batch, n_layers, k, s)
                  : launch_fwd<2>(a, b, u, v, o, p, d, batch, n_layers, k, s);
  return static_cast<int>(err);
}

// ws is (4, n_layers, d, Bp) scratch, Bp = batch rounded up to `cols`;
// dur, dui are (n_layers, d, d); dpr, dpi are (d, batch); cols (8 or 16)
// samples a tile, as in the forward.
int unitary_chain_bwd(const void* pr, const void* pi, const void* ur,
                      const void* ui, const void* fr, const void* fi,
                      const void* gr, const void* gi, void* ws, void* dur,
                      void* dui, void* dpr, void* dpi, int wires, int batch,
                      int n_layers, int k, int cols, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 1 << wires;
  if (d < 2 || d > kMaxDim || batch < 1 || n_layers < 1 || k < 1 ||
      (cols != 8 && cols != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(pr);
  const auto* b = static_cast<const float*>(pi);
  const auto* u = static_cast<const float*>(ur);
  const auto* v = static_cast<const float*>(ui);
  const auto* f0 = static_cast<const float*>(fr);
  const auto* f1 = static_cast<const float*>(fi);
  const auto* g0 = static_cast<const float*>(gr);
  const auto* g1 = static_cast<const float*>(gi);
  auto* w = static_cast<float*>(ws);
  auto* du0 = static_cast<float*>(dur);
  auto* du1 = static_cast<float*>(dui);
  auto* q0 = static_cast<float*>(dpr);
  auto* q1 = static_cast<float*>(dpi);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cols == 8 ? launch_bwd<1>(a, b, u, v, f0, f1, g0, g1, w, du0, du1,
                                  q0, q1, d, batch, n_layers, k, s)
                  : launch_bwd<2>(a, b, u, v, f0, f1, g0, g1, w, du0, du1,
                                  q0, q1, d, batch, n_layers, k, s);
  return static_cast<int>(err);
}

}  // extern "C"
