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
// Forward design. A block owns a tile of R consecutive samples (R = 1 up
// to a batch of 132, the card's SMs, else 2; the wrapper picks it) and
// runs one thread per output row j (max(d, 32) threads). The tile's state
// sits in shared memory, double-buffered: 2 x 2 x d x R floats (8 KB at
// d = 256, R = 2). U_l is staged through shared memory in chunks of ic = min(32, d)
// columns, double-buffered with asynchronous copies (cp.async): while the
// block works on one chunk, the next one (of this layer or the next; U
// does not depend on the state) streams in, so the L2 latency hides
// behind the arithmetic. Consecutive threads copy consecutive floats of
// one row of U_l (coalesced) into a transposed chunk with a padded stride
// of d + 1 (no bank conflicts), so that thread j reads its row's chunk at
// consecutive addresses while the state values are broadcast, R of them
// in one vector load. Each U value loaded feeds R complex multiply-adds,
// summed a chunk at a time into the row's total (32-term partial sums).
// The phase of a block start is folded into the store of the previous
// layer's output (and into the start state at l = 0), so a layer costs
// 2 d / ic barriers and no extra pass.
//
// What bounds the forward on this card. At the route's widest block
// (w = 8, L*k = 28, B = 80) the arithmetic is 8 L k B d^2 = 1.2 GFLOP and
// the unitaries are 14.7 MB: against the card's peaks both take ~18 us.
// Every block reads all L*k unitaries once, so the tiles re-read them
// ceil(B/R) times; 14.7 MB stays in the 50 MB L2, which serves the re-reads.
// A small R spreads the batch over more SMs but multiplies the L2 traffic;
// a large R does more arithmetic per value loaded on fewer SMs (on the
// H100 tiles of 4 and 8 samples ran slower than 1 or 2 at B = 80 and 255).
// wgmma on TF32 pairs, TMA staging and clusters sharing one U_l are later
// work.
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"

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

template <int R>
__global__ void __launch_bounds__(kMaxDim)
    unitary_chain_fwd_kernel(const float* __restrict__ pr,
                             const float* __restrict__ pi,
                             const float* __restrict__ ur,
                             const float* __restrict__ ui,
                             float* __restrict__ out_r,
                             float* __restrict__ out_i, int d, int batch,
                             int n_layers, int k) {
  extern __shared__ float2 smem2[];  // 8-byte aligned for load_row
  float* smem = reinterpret_cast<float*>(smem2);
  const int ic = d < kChunk ? d : kChunk;
  const int ic_shift = __ffs(ic) - 1;  // ic is a power of two
  const int nc_shift = __ffs(d) - 1 - ic_shift;  // d / ic chunks a layer
  const int n_chunks = 1 << nc_shift;
  const int n_total = n_layers << nc_shift;
  const int stride = d + 1;            // padded row of a staged chunk
  const int stage = 2 * ic * stride;   // floats of one staged chunk
  const int tid = threadIdx.x;
  const int j = tid;                   // this thread's output row
  const bool row = j < d;
  const int b0 = blockIdx.x * R;
  // staging: thread tid copies column sc of rows sj, sj + pass, ...
  const int sc = tid & (ic - 1);
  const int sj = tid >> ic_shift;
  const int pass = blockDim.x >> ic_shift;
  float* st = smem;                    // [buffer][re, im][d][R]
  float* us = smem + 4 * d * R;        // [stage][re, im][ic][d + 1]

  // chunk g = (layer g / n_chunks, columns (g % n_chunks) ic ...) into
  // stage g & 1, transposed
  auto stage_chunk = [&](int g) {
    const size_t at = static_cast<size_t>(g >> nc_shift) * d * d +
                      ((g & (n_chunks - 1)) << ic_shift) + sc;
    float* dst = us + (g & 1) * stage + sc * stride;
    for (int jj = sj; jj < d; jj += pass) {
      const size_t src = at + static_cast<size_t>(jj) * d;
      copy_async(dst + jj, ur + src);
      copy_async(dst + ic * stride + jj, ui + src);
    }
    __pipeline_commit();
  };

  // this row's phases for the tile's samples; 0 past the batch
  float ph_r[R], ph_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    const bool in = row && b < batch;
    ph_r[r] = in ? pr[static_cast<size_t>(j) * batch + b] : 0.0f;
    ph_i[r] = in ? pi[static_cast<size_t>(j) * batch + b] : 0.0f;
  }
  // |0...0> times the phase of layer 0
  if (row) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      st[j * R + r] = (j == 0) ? ph_r[r] : 0.0f;
      st[(d + j) * R + r] = (j == 0) ? ph_i[r] : 0.0f;
    }
  }

  float acc_r[R], acc_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc_r[r] = acc_i[r] = 0.0f;
  int cur = 0;
  stage_chunk(0);
  for (int g = 0; g < n_total; ++g) {
    // the next chunk streams in while this one is used
    if (g + 1 < n_total) {
      stage_chunk(g + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // chunk g has landed; at a layer's first chunk, its input is written
    __syncthreads();
    const int l = g >> nc_shift;
    const int c0 = (g & (n_chunks - 1)) << ic_shift;
    if (row) {
      const float* sr = st + cur * 2 * d * R + c0 * R;
      const float* si = sr + d * R;
      const float* u_r = us + (g & 1) * stage + j;
      const float* u_i = u_r + ic * stride;
      float par_r[R], par_i[R];  // this chunk's partial sums
#pragma unroll
      for (int r = 0; r < R; ++r) par_r[r] = par_i[r] = 0.0f;
      for (int c = 0; c < ic; ++c) {
        const float a = u_r[c * stride];
        const float q = u_i[c * stride];
        float xr[R], xi[R];
        load_row<R>(sr + c * R, xr);
        load_row<R>(si + c * R, xi);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          par_r[r] += a * xr[r] - q * xi[r];
          par_i[r] += a * xi[r] + q * xr[r];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc_r[r] += par_r[r];
        acc_i[r] += par_i[r];
      }
    }
    if (c0 + ic == d && l + 1 < n_layers) {  // the layer's output
      cur ^= 1;
      if (row) {
        float* nr = st + cur * 2 * d * R;
        float* ni = nr + d * R;
        const bool phase = (l + 1) % k == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float vr = acc_r[r], vi = acc_i[r];
          if (phase) {
            const float t = vr * ph_r[r] - vi * ph_i[r];
            vi = vr * ph_i[r] + vi * ph_r[r];
            vr = t;
          }
          nr[j * R + r] = vr;
          ni[j * R + r] = vi;
          acc_r[r] = acc_i[r] = 0.0f;
        }
      }
    }
    // stage g & 1 is read before chunk g + 2 overwrites it
    __syncthreads();
  }

  if (row) {  // the last layer's output
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      if (b < batch) {
        out_r[static_cast<size_t>(j) * batch + b] = acc_r[r];
        out_i[static_cast<size_t>(j) * batch + b] = acc_i[r];
      }
    }
  }
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

// The state buffers and two staged chunks of U.
size_t fwd_smem(int d, int tile) {
  const int ic = chunk_for(d);
  return (4 * static_cast<size_t>(d) * tile +
          4 * static_cast<size_t>(ic) * (d + 1)) *
         sizeof(float);
}

size_t bwd_smem(int d, int tile) {
  const int jc = chunk_for(d);
  return (8 * static_cast<size_t>(d) * tile +
          4 * static_cast<size_t>(jc) * d) *
         sizeof(float);
}

template <int R>
cudaError_t launch_fwd(const float* pr, const float* pi, const float* ur,
                       const float* ui, float* out_r, float* out_i, int d,
                       int batch, int n_layers, int k, cudaStream_t s) {
  const size_t smem = fwd_smem(d, R);
  cudaError_t err = allow_smem(unitary_chain_fwd_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  unitary_chain_fwd_kernel<R><<<(batch + R - 1) / R, unitary_threads(d),
                                smem, s>>>(pr, pi, ur, ui, out_r, out_i, d,
                                           batch, n_layers, k);
  return cudaGetLastError();
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

// Shared-memory bytes one block of each kernel needs at a tile of `tile`
// samples; the wrapper checks them against the card's per-block limit.
size_t unitary_chain_fwd_smem_bytes(int wires, int tile) {
  return fwd_smem(1 << wires, tile);
}

size_t unitary_chain_bwd_smem_bytes(int wires, int tile) {
  return bwd_smem(1 << wires, tile);
}

// pr, pi, out_r, out_i are (d, batch); ur, ui are (n_layers, d, d);
// tile is 1 or 2 samples a block.
int unitary_chain_fwd(const void* pr, const void* pi, const void* ur,
                      const void* ui, void* out_r, void* out_i, int wires,
                      int batch, int n_layers, int k, int tile, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 1 << wires;
  if (d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(pr);
  const auto* b = static_cast<const float*>(pi);
  const auto* u = static_cast<const float*>(ur);
  const auto* v = static_cast<const float*>(ui);
  auto* o = static_cast<float*>(out_r);
  auto* p = static_cast<float*>(out_i);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != 1 && tile != 2) return static_cast<int>(cudaErrorInvalidValue);
  err = tile == 1 ? launch_fwd<1>(a, b, u, v, o, p, d, batch, n_layers, k, s)
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
