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
// on the TPU. A thread owns input row i of the tile and reads U_l[j, i] for
// j = 0..d-1: rows of U_l, which the block stages as they lie in memory,
// 32 rows a chunk, double-buffered with cp.async as in the forward. A block
// owns its samples, so dpr and dpi need no cross-block sum.
//
// unitary_chain_du_kernel, a helper of #14 (counted with it, as #2's dg sum
// is): dU_l[j, i] = sum_b c_l[b, j] conj(t_l[b, i]) over the whole batch,
//   dur = sum_b c_r[j] t_r[i] + c_i[j] t_i[i],
//   dui = sum_b c_i[j] t_r[i] - c_r[j] t_i[i],
// over a grid of (32 x 32 tile of dU_l, layer l), each output summing b in
// increasing order: no atomics, the same bits on every run. The workspace
// is (4, n_layers, B, d) floats, 9.2 MB at w = 8, L*k = 28, B = 80.
//
// What bounds the backward. Three times the forward's products (the state's
// rebuild, the cotangent's push, dU), the unitaries read once and dU
// written once (29 MB at w = 8, L*k = 28), and the workspace round trip.
//
// Plain C interface (bound with ctypes): each launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"
#include "wide_common.cuh"  // the 3xTF32 mma.sync units and cp.async

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 256;  // MAX_FUSED_DIM
constexpr int kChunk = 32;    // columns of U staged at a time
constexpr int kTile = 32;     // dU tile edge
constexpr int kRowsPerThread = 4;  // dU rows a thread of the 32 x 8 block

inline int unitary_threads(int d) { return d > 32 ? d : 32; }

inline int chunk_for(int d) { return d < kChunk ? d : kChunk; }

// The R values of one row of a [d][R] shared-memory plane in one load
// (R floats at a multiple of R).
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  static_assert(R == 1 || R == 2, "tiles of 1 or 2 samples");
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Async copy of 4 bytes from global to shared memory (cp.async); the
// copies a thread issues between two commits form one group.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

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

template <int R>
__global__ void __launch_bounds__(kMaxDim)
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
                             int n_layers, int k) {
  extern __shared__ float2 smem2[];  // 8-byte aligned for load_row
  float* smem = reinterpret_cast<float*>(smem2);
  const int jc = d < kChunk ? d : kChunk;  // rows of U a chunk
  const int jc_shift = __ffs(jc) - 1;
  const int nc_shift = __ffs(d) - 1 - jc_shift;
  const int n_chunks = 1 << nc_shift;
  const int n_total = n_layers << nc_shift;
  const int stage = 2 * jc * d;      // floats of one staged chunk
  const int i = threadIdx.x;         // this thread's input row
  const int nt = blockDim.x;
  const bool row = i < d;
  const int b0 = blockIdx.x * R;
  const int plane = d * R;
  float* us = smem + 8 * plane;      // [stage][re, im][jc][d]
  // one workspace plane: (n_layers, batch, d)
  const size_t wsp = static_cast<size_t>(n_layers) * batch * d;

  // chunk g = (layer n_layers - 1 - g / n_chunks, rows (g % n_chunks) jc
  // ...) into stage g & 1, as it lies in U (rows contiguous)
  auto stage_chunk = [&](int g) {
    const int l = n_layers - 1 - (g >> nc_shift);
    const size_t at = (static_cast<size_t>(l) * d +
                       ((g & (n_chunks - 1)) << jc_shift)) * d;
    float* dst = us + (g & 1) * stage;
    for (int e = i; e < jc * d; e += nt) {
      copy_async(dst + e, ur + at + e);
      copy_async(dst + jc * d + e, ui + at + e);
    }
    __pipeline_commit();
  };

  float ph_r[R], ph_i[R], dp_r[R], dp_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    const bool in = row && b < batch;
    const size_t at = static_cast<size_t>(i) * batch + b;
    ph_r[r] = in ? pr[at] : 0.0f;
    ph_i[r] = in ? pi[at] : 0.0f;
    dp_r[r] = 0.0f;
    dp_i[r] = 0.0f;
    if (row) {  // [buffer][s_r, s_i, c_r, c_i][d][R]
      smem[i * R + r] = in ? fr[at] : 0.0f;
      smem[plane + i * R + r] = in ? fi[at] : 0.0f;
      smem[2 * plane + i * R + r] = in ? gr[at] : 0.0f;
      smem[3 * plane + i * R + r] = in ? gi[at] : 0.0f;
    }
  }

  float t_r[R], t_i[R], n_r[R], n_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t_r[r] = t_i[r] = n_r[r] = n_i[r] = 0.0f;
  int cur = 0;
  stage_chunk(0);
  for (int g = 0; g < n_total; ++g) {
    if (g + 1 < n_total) {
      stage_chunk(g + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // chunk g has landed; at a layer's first chunk, the state and
    // cotangent after the layer are written
    __syncthreads();
    const int l = n_layers - 1 - (g >> nc_shift);
    const int j0 = (g & (n_chunks - 1)) << jc_shift;
    const float* s_r = smem + cur * 4 * plane;
    const float* s_i = s_r + plane;
    const float* c_r = s_i + plane;
    const float* c_i = c_r + plane;
    if (row) {
      // rows j0.. of U_l: conj(U_l[j, i]) = a - i q
      const float* u_r = us + (g & 1) * stage + i;
      const float* u_i = u_r + jc * d;
      float pt_r[R], pt_i[R], pn_r[R], pn_i[R];  // this chunk's partials
#pragma unroll
      for (int r = 0; r < R; ++r) pt_r[r] = pt_i[r] = pn_r[r] = pn_i[r] = 0.0f;
      for (int jj = 0; jj < jc; ++jj) {
        const float a = u_r[jj * d];
        const float q = u_i[jj * d];
        const int at = (j0 + jj) * R;
        float xr[R], xi[R], yr[R], yi[R];
        load_row<R>(s_r + at, xr);
        load_row<R>(s_i + at, xi);
        load_row<R>(c_r + at, yr);
        load_row<R>(c_i + at, yi);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pt_r[r] += a * xr[r] + q * xi[r];
          pt_i[r] += a * xi[r] - q * xr[r];
          pn_r[r] += a * yr[r] + q * yi[r];
          pn_i[r] += a * yi[r] - q * yr[r];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t_r[r] += pt_r[r];
        t_i[r] += pt_i[r];
        n_r[r] += pn_r[r];
        n_i[r] += pn_i[r];
      }
    }
    if (j0 + jc == d) {  // layer l is done
      if (row) {
        float* nxt = smem + (cur ^ 1) * 4 * plane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int b = b0 + r;
          if (b < batch) {  // dU_l's inputs: t_l and the cotangent after U_l
            const size_t at = (static_cast<size_t>(l) * batch + b) * d + i;
            ws[at] = t_r[r];
            ws[wsp + at] = t_i[r];
            ws[2 * wsp + at] = c_r[i * R + r];
            ws[3 * wsp + at] = c_i[i * R + r];
          }
          float sr = t_r[r], si = t_i[r], cr = n_r[r], ci = n_i[r];
          if (l % k == 0) {
            const float p = ph_r[r], q = ph_i[r];
            sr = t_r[r] * p + t_i[r] * q;  // the state before the phase
            si = t_i[r] * p - t_r[r] * q;
            dp_r[r] += n_r[r] * sr + n_i[r] * si;
            dp_i[r] += n_i[r] * sr - n_r[r] * si;
            cr = n_r[r] * p + n_i[r] * q;
            ci = n_i[r] * p - n_r[r] * q;
          }
          nxt[i * R + r] = sr;
          nxt[plane + i * R + r] = si;
          nxt[2 * plane + i * R + r] = cr;
          nxt[3 * plane + i * R + r] = ci;
          t_r[r] = t_i[r] = n_r[r] = n_i[r] = 0.0f;
        }
      }
      cur ^= 1;
    }
    // stage g & 1 is read before chunk g + 2 overwrites it
    __syncthreads();
  }

  if (row) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      if (b < batch) {
        dpr[static_cast<size_t>(i) * batch + b] = dp_r[r];
        dpi[static_cast<size_t>(i) * batch + b] = dp_i[r];
      }
    }
  }
}

// Block (32, 8): thread (x, y) forms dU_l[j0 + y + 8 m, i0 + x], m = 0..3.
__global__ void __launch_bounds__(kTile * 8)
    unitary_chain_du_kernel(const float* __restrict__ ws,
                            float* __restrict__ dur, float* __restrict__ dui,
                            int d, int batch, int n_layers) {
  __shared__ float ts_r[kTile][kTile], ts_i[kTile][kTile];
  __shared__ float cs_r[kTile][kTile], cs_i[kTile][kTile];
  const int x = threadIdx.x, y = threadIdx.y;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const int l = blockIdx.z;
  const size_t wsp = static_cast<size_t>(n_layers) * batch * d;
  const float* t_r = ws + static_cast<size_t>(l) * batch * d;
  const float* t_i = t_r + wsp;
  const float* c_r = t_r + 2 * wsp;
  const float* c_i = t_r + 3 * wsp;
  float acc_r[kRowsPerThread], acc_i[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) acc_r[m] = acc_i[m] = 0.0f;
  for (int bb = 0; bb < batch; bb += kTile) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int q = y + 8 * m;
      const int b = bb + q;
      const size_t at = static_cast<size_t>(b) * d;
      const bool ti_in = b < batch && i0 + x < d;
      const bool cj_in = b < batch && j0 + x < d;
      ts_r[q][x] = ti_in ? t_r[at + i0 + x] : 0.0f;
      ts_i[q][x] = ti_in ? t_i[at + i0 + x] : 0.0f;
      cs_r[q][x] = cj_in ? c_r[at + j0 + x] : 0.0f;
      cs_i[q][x] = cj_in ? c_i[at + j0 + x] : 0.0f;
    }
    __syncthreads();
    const int nb = batch - bb < kTile ? batch - bb : kTile;
    for (int q = 0; q < nb; ++q) {  // b in increasing order
      const float a = ts_r[q][x], e = ts_i[q][x];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const float u = cs_r[q][y + 8 * m], v = cs_i[q][y + 8 * m];
        acc_r[m] += u * a + v * e;
        acc_i[m] += v * a - u * e;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int jr = j0 + y + 8 * m, ic = i0 + x;
    if (jr < d && ic < d) {
      const size_t at = (static_cast<size_t>(l) * d + jr) * d + ic;
      dur[at] = acc_r[m];
      dui[at] = acc_i[m];
    }
  }
}

// The state buffers and two staged chunks of U a backward block.
size_t bwd_smem(int d, int tile) {
  const int jc = chunk_for(d);
  return (8 * static_cast<size_t>(d) * tile +
          4 * static_cast<size_t>(jc) * d) *
         sizeof(float);
}

// Sets the forward's attributes for a tile of 8 NB samples and fills cfg
// for `batch` samples: ceil(batch / (8 NB)) clusters of fwd_cluster(d)
// CTAs; attr (one entry) must outlive cfg.
template <int NB>
cudaError_t fwd_config(int d, int batch, cudaStream_t stream,
                       cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const int cluster = fwd_cluster(d);
  const size_t smem = fwd_smem(d, 8 * NB);
  cudaError_t err = allow_smem(unitary_chain_fwd_kernel<NB>, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(unitary_chain_fwd_kernel<NB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((batch + 8 * NB - 1) / (8 * NB) * cluster);
  cfg->blockDim = dim3(kFwdThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
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

template <int R>
cudaError_t launch_bwd(const float* pr, const float* pi, const float* ur,
                       const float* ui, const float* fr, const float* fi,
                       const float* gr, const float* gi, float* ws,
                       float* dpr, float* dpi, int d, int batch,
                       int n_layers, int k, cudaStream_t s) {
  const size_t smem = bwd_smem(d, R);
  cudaError_t err = allow_smem(unitary_chain_bwd_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  unitary_chain_bwd_kernel<R><<<(batch + R - 1) / R, unitary_threads(d),
                                smem, s>>>(pr, pi, ur, ui, fr, fi, gr, gi,
                                           ws, dpr, dpi, d, batch, n_layers,
                                           k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a forward CTA needs at a tile of `cols` samples, and
// a backward block at a tile of `tile`; the wrapper checks them against
// the card's per-block limit.
size_t unitary_chain_fwd_smem_bytes(int wires, int cols) {
  return fwd_smem(1 << wires, cols);
}

size_t unitary_chain_bwd_smem_bytes(int wires, int tile) {
  return bwd_smem(1 << wires, tile);
}

// How many forward clusters (fwd_cluster(d) CTAs each) the card holds at
// once at a tile of `cols` samples (0: none, and the launch is refused; a
// negative cudaError on failure); chip_smoke.py prints it with the plan.
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

// ws is (4, n_layers, batch, d) scratch; dur, dui are (n_layers, d, d);
// dpr, dpi are (d, batch).
int unitary_chain_bwd(const void* pr, const void* pi, const void* ur,
                      const void* ui, const void* fr, const void* fi,
                      const void* gr, const void* gi, void* ws, void* dur,
                      void* dui, void* dpr, void* dpi, int wires, int batch,
                      int n_layers, int k, int tile, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 1 << wires;
  if (d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(pr);
  const auto* b = static_cast<const float*>(pi);
  const auto* u = static_cast<const float*>(ur);
  const auto* v = static_cast<const float*>(ui);
  const auto* f0 = static_cast<const float*>(fr);
  const auto* f1 = static_cast<const float*>(fi);
  const auto* g0 = static_cast<const float*>(gr);
  const auto* g1 = static_cast<const float*>(gi);
  auto* w = static_cast<float*>(ws);
  auto* q0 = static_cast<float*>(dpr);
  auto* q1 = static_cast<float*>(dpi);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != 1 && tile != 2) return static_cast<int>(cudaErrorInvalidValue);
  err = tile == 1 ? launch_bwd<1>(a, b, u, v, f0, f1, g0, g1, w, q0, q1, d,
                                  batch, n_layers, k, s)
                  : launch_bwd<2>(a, b, u, v, f0, f1, g0, g1, w, q0, q1, d,
                                  batch, n_layers, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d + kTile - 1) / kTile;
  unitary_chain_du_kernel<<<dim3(tiles, tiles, n_layers), dim3(kTile, 8), 0,
                            s>>>(w, static_cast<float*>(dur),
                                 static_cast<float*>(dui), d, batch,
                                 n_layers);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
