// Wide re-uploading chain (1-20 wires; the engine routes 11-20 here): the
// grouped sublayer forward (kernel #11) and its adjoint backward (kernel
// #12), for NVIDIA Hopper (sm_90a).
//
// #11 replaces qiddm_tpu/sim/pallas_wide_kernel.py::_sub_fwd_kernel
// (reached from wide_fwd_scan). One sublayer of the chain on a batch of
// states: for each wire group g in order, s <- G_g s on the group's bit
// axis, G_g the (2^s x 2^s) Kronecker product of the group's per-wire
// rotations; then the CZ ring's +-1 sign on every basis row. The chain
// runs, from |0...0>, L spectrum layers of [RZ phase, k sublayers].
//
// #12 replaces _sub_bwd_kernel (reached from wide_bwd_scan): the sublayer
// walked in reverse, undoing the signs on the state and the cotangent,
// then for each group in reverse: rebuild the group's input state
// s_in = G^H s_out, add the group gradient dG = sum over columns of
// c_out (x) conj(s_in), and carry the cotangent back, c_in = G^H c_out.
// Between layers the RZ phase is undone the same way (its gradient is
// c_out (x) conj(s_in) elementwise). No per-layer state is stored: the
// states are rebuilt through G^H, as on the TPU. This is PyTorch's
// convention for complex gradients (a real loss, gradient re + i im);
// the JAX package pushes cotangents through the unconjugated G^T and
// forms dG without the conjugate, which is the complex conjugate of the
// same numbers. The wrapper works on real planes, so no conjugate is
// written anywhere but here.
//
// Layout. States are the port's (d, B) float32 planes (real, imaginary),
// d = 2^w, wire 0 the most significant bit. In that layout the group at bit
// offset `off` and width `s` is the middle axis of a (2^off, 2^s, post B)
// view, post = 2^(w - off - s): a column (p, q) of that view, q < post B,
// holds the D = 2^s amplitudes at (p D + y) post B + q, y < D. The batch
// folds into q, so one group product is a complex (D x D) by (D x ncols)
// matrix product over ncols = 2^(w-s) B columns. The JAX kernel instead
// packs 2^(20-w) samples into one 2^20 superstate with identity groups on
// the batch bits and cycles the layout by transposes between groups; that
// is the TPU's layout, not the function, and is not carried over.
//
// Forward design (wide_group_kernel, NRHS = 1). One launch per group. A
// block owns a tile of 32 consecutive columns and reads its D x 32 complex
// tile into shared memory (32 KB at D = 128), so it may write its result
// over its input: no other block touches those columns. op(G) is staged
// through shared memory 16 rows at a time. Lane = column, warp = rows
// x = warp + 8 i: each thread keeps D/8 complex sums, reads its column's
// amplitude once per y and op(G)[x][y] as a broadcast. Prologues: the first
// group of a chain starts from |0...0> (no input read), the first group of
// each spectrum layer multiplies in the RZ phase planes, and the backward's
// first group undoes the ring signs; the ring signs of the last group are
// its epilogue. The signs come from the parity of row & rotl_w(row, r), so
// no sign table is read.
//
// Backward design. Per group, three launches: wide_group_kernel with
// NRHS = 2 rebuilds the state in place and writes G^H c into a second
// cotangent buffer (the same matrix, two right-hand sides); then
// wide_group_dg_kernel forms dG from the cotangent before the push and the
// rebuilt state: a (D x D) product over all ncols columns, split into
// nsplit column ranges, each block one (<= 64 x 64) tile of dG over one
// range, its partial written to a scratch of (nsplit, D, D, 2) floats; and
// wide_dg_reduce_kernel sums the partials over the splits in a fixed order.
// No atomics: a run gives the same bits every time. Between layers
// wide_unencode_kernel undoes the phase on state and cotangent and adds the
// phase gradient.
//
// The kernels here are thin: each runs one device function of
// wide_common.cuh (group_tile, dg_unit, dg_reduce_at, unencode_at) on its
// block's tile. The monolithic chain of wide_mono.cu (#9/#10) runs the same
// functions on the same tiles in one cooperative launch.
//
// What bounds it on this card. Per sublayer the groups do
// 8 ncols D^2 = 8 B 2^w sum_g 2^(s_g) flops: 671 MFLOP at w=16, B=10
// (groups 6, 5, 5), 21.5 GFLOP at w=20, B=8 (7, 7, 6), bound by the float32
// peak (10 us and 320 us at 67 TFLOP/s); the planes move 2 x 8 B per
// amplitude per group, 31 MB at w=16, B=10. The backward does three such
// products a group. Arithmetic is float32 FMA on the CUDA cores, no TF32
// (the JAX kernel pins precision "highest"): each thread's inner step is
// one shared-memory broadcast per 4 FMAs, so shared-memory bandwidth, not
// the FMA rate, bounds this simple design. wgmma with 3xTF32, and clusters
// holding one state in distributed shared memory, are later work.
//
// Indices are 64-bit: d B passes 2^31 at w=20 from B=2048.
//
// Plain C interface (bound with ctypes): each entry launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// first launch error (cudaGetLastError()).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "chain_common.cuh"
#include "wide_common.cuh"

namespace {

// One 32-column tile of out_j = op(G) in_j a block (group_tile).
template <int NRHS, int RX>
__global__ void __launch_bounds__(256)
    wide_group_kernel(const float* in0r, const float* in0i, float* out0r,
                      float* out0i, const float* in1r, const float* in1i,
                      float* out1r, float* out1i,
                      const float* __restrict__ gr,
                      const float* __restrict__ gi,
                      const float* __restrict__ phr,
                      const float* __restrict__ phi, int zero_in,
                      int adjoint, int sign_in, int sign_out, int size,
                      int wires, long long post_b, int batch,
                      long long ncols) {
  extern __shared__ float2 smem2[];
  group_tile<NRHS, RX>(blockIdx.x, smem2, in0r, in0i, out0r, out0i, in1r,
                       in1i, out1r, out1i, gr, gi, phr, phi, zero_in,
                       adjoint, sign_in, sign_out, size, wires, post_b, batch,
                       ncols);
}

// One unit of the dG product a block (dg_unit): block (tile, split) writes
// part[split][x][y][re, im].
template <int M>
__global__ void __launch_bounds__(256)
    wide_group_dg_kernel(const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const float* __restrict__ sr,
                         const float* __restrict__ si,
                         float* __restrict__ part, int sign_c, int size,
                         int wires, long long post_b, int batch,
                         long long ncols, long long per_split) {
  __shared__ float2 cs[kDgK * 16 * M];
  __shared__ float2 ss[kDgK * 16 * M];
  dg_unit<M>(blockIdx.x, cs, ss, cr, ci, sr, si, part, sign_c, size, wires,
             post_b, batch, ncols, per_split);
}

// dg[t] = sum over the splits of part[split][t], splits in increasing order.
__global__ void wide_dg_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dgr,
                                      float* __restrict__ dgi, int n,
                                      int nsplit) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  dg_reduce_at(t, part, dgr, dgi, n, nsplit);
}

// Undo the RZ phase on the state and the cotangent (both in place) and add
// the phase gradient c conj(s_before) to (dpr, dpi); `first` writes it.
__global__ void wide_unencode_kernel(const float* __restrict__ pr,
                                     const float* __restrict__ pi,
                                     float* __restrict__ sr,
                                     float* __restrict__ si,
                                     float* __restrict__ cr,
                                     float* __restrict__ ci,
                                     float* __restrict__ dpr,
                                     float* __restrict__ dpi, long long n,
                                     int first) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  unencode_at(i, pr, pi, sr, si, cr, ci, dpr, dpi, first);
}

template <int NRHS, int RX>
cudaError_t launch_group_rx(const float* in0r, const float* in0i,
                            float* out0r, float* out0i, const float* in1r,
                            const float* in1i, float* out1r, float* out1i,
                            const float* gr, const float* gi,
                            const float* phr, const float* phi, int zero_in,
                            int adjoint, int sign_in, int sign_out, int size,
                            int wires, long long post_b, int batch,
                            long long ncols, cudaStream_t stream) {
  const int dim = 1 << size;
  const size_t smem = group_smem(NRHS, dim);
  cudaError_t err = allow_smem(wide_group_kernel<NRHS, RX>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (ncols + kTile - 1) / kTile;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  wide_group_kernel<NRHS, RX><<<static_cast<unsigned>(blocks),
                                32 * warps_for(dim), smem, stream>>>(
      in0r, in0i, out0r, out0i, in1r, in1i, out1r, out1i, gr, gi, phr, phi,
      zero_in, adjoint, sign_in, sign_out, size, wires, post_b, batch, ncols);
  return cudaGetLastError();
}

template <int NRHS>
cudaError_t launch_group(const float* in0r, const float* in0i, float* out0r,
                         float* out0i, const float* in1r, const float* in1i,
                         float* out1r, float* out1i, const float* gr,
                         const float* gi, const float* phr, const float* phi,
                         int zero_in, int adjoint, int sign_in, int sign_out,
                         int size, int wires, long long post_b, int batch,
                         long long ncols, cudaStream_t stream) {
  const int dim = 1 << size;
  switch (dim / warps_for(dim)) {
#define WIDE_GROUP_CASE(RX)                                                   \
  case RX:                                                                    \
    return launch_group_rx<NRHS, RX>(in0r, in0i, out0r, out0i, in1r, in1i,   \
                                     out1r, out1i, gr, gi, phr, phi, zero_in, \
                                     adjoint, sign_in, sign_out, size, wires, \
                                     post_b, batch, ncols, stream);
    WIDE_GROUP_CASE(1)
    WIDE_GROUP_CASE(2)
    WIDE_GROUP_CASE(4)
    WIDE_GROUP_CASE(8)
    WIDE_GROUP_CASE(16)
#undef WIDE_GROUP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dg(const float* cr, const float* ci, const float* sr,
                      const float* si, float* part, float* dgr, float* dgi,
                      int sign_c, int size, int wires, long long post_b,
                      int batch, long long ncols, cudaStream_t stream) {
  const int dim = 1 << size;
  const DgSplit d = dg_split(size, ncols);
  const long long blocks = static_cast<long long>(d.tiles) * d.nsplit;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  const int m = dg_m(dim);
  if (m == 4) {
    wide_group_dg_kernel<4><<<grid, 256, 0, stream>>>(
        cr, ci, sr, si, part, sign_c, size, wires, post_b, batch, ncols,
        d.per_split);
  } else if (m == 2) {
    wide_group_dg_kernel<2><<<grid, 256, 0, stream>>>(
        cr, ci, sr, si, part, sign_c, size, wires, post_b, batch, ncols,
        d.per_split);
  } else {
    wide_group_dg_kernel<1><<<grid, 256, 0, stream>>>(
        cr, ci, sr, si, part, sign_c, size, wires, post_b, batch, ncols,
        d.per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = dim * dim;
  wide_dg_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dgr, dgi,
                                                             n, d.nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward chain from |0...0>: n_layers = L*k sublayers, the RZ phase planes
// (pr, pi) before sublayers 0, k, 2k, ...; group g's matrices are
// (gr[g], gi[g]), each (n_layers, 2^s_g, 2^s_g) float32, s_g = sizes[g]
// (sizes[g] = 0 past the last group). Writes the state planes (sr, si),
// each (2^w, batch).
int wide_chain_fwd(const void* pr, const void* pi, const void* g0r,
                   const void* g0i, const void* g1r, const void* g1i,
                   const void* g2r, const void* g2i, void* sr, void* si,
                   int s0, int s1, int s2, int wires, int batch,
                   int n_layers, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sizes[kMaxGroups] = {s0, s1, s2};
  const Groups grp = make_groups(sizes, wires, batch);
  const float* gr[kMaxGroups] = {static_cast<const float*>(g0r),
                                 static_cast<const float*>(g1r),
                                 static_cast<const float*>(g2r)};
  const float* gi[kMaxGroups] = {static_cast<const float*>(g0i),
                                 static_cast<const float*>(g1i),
                                 static_cast<const float*>(g2i)};
  float* out_r = static_cast<float*>(sr);
  float* out_i = static_cast<float*>(si);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < n_layers; ++l) {
    const int li = l % k;
    for (int g = 0; g < grp.n; ++g) {
      const int dim = 1 << grp.size[g];
      const size_t gm = static_cast<size_t>(l) * dim * dim;
      const bool first = li == 0 && g == 0;
      err = launch_group<1>(
          out_r, out_i, out_r, out_i, nullptr, nullptr, nullptr, nullptr,
          gr[g] + gm, gi[g] + gm,
          first ? static_cast<const float*>(pr) : nullptr,
          first ? static_cast<const float*>(pi) : nullptr,
          first && l == 0, 0, 0,
          g == grp.n - 1 ? ring_range(li, wires) : 0, grp.size[g], wires,
          grp.post_b[g], batch, grp.ncols[g], s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

// Floats of dG partials the backward needs (its `part` scratch).
size_t wide_chain_bwd_part_floats(int s0, int s1, int s2, int wires,
                                  int batch) {
  const int sizes[kMaxGroups] = {s0, s1, s2};
  const Groups grp = make_groups(sizes, wires, batch);
  size_t most = 0;
  for (int g = 0; g < grp.n; ++g) {
    const DgSplit d = dg_split(grp.size[g], grp.ncols[g]);
    const size_t dim = size_t{1} << grp.size[g];
    const size_t need = static_cast<size_t>(d.nsplit) * dim * dim * 2;
    if (need > most) most = need;
  }
  return most;
}

// Adjoint backward of wide_chain_fwd. (sr, si) hold the forward's output
// and (cr, ci) the output cotangent, (tr, ti) scratch planes of the same
// shape: all four pairs are overwritten. part holds
// wide_chain_bwd_part_floats() floats. Writes the group gradients
// (dg*r, dg*i), shaped as the groups, and the phase-plane gradients
// (dpr, dpi).
int wide_chain_bwd(const void* pr, const void* pi, const void* g0r,
                   const void* g0i, const void* g1r, const void* g1i,
                   const void* g2r, const void* g2i, void* sr, void* si,
                   void* cr, void* ci, void* tr, void* ti, void* part,
                   void* dg0r, void* dg0i, void* dg1r, void* dg1i,
                   void* dg2r, void* dg2i, void* dpr, void* dpi, int s0,
                   int s1, int s2, int wires, int batch, int n_layers, int k,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sizes[kMaxGroups] = {s0, s1, s2};
  const Groups grp = make_groups(sizes, wires, batch);
  const float* gr[kMaxGroups] = {static_cast<const float*>(g0r),
                                 static_cast<const float*>(g1r),
                                 static_cast<const float*>(g2r)};
  const float* gi[kMaxGroups] = {static_cast<const float*>(g0i),
                                 static_cast<const float*>(g1i),
                                 static_cast<const float*>(g2i)};
  float* dgr[kMaxGroups] = {static_cast<float*>(dg0r),
                            static_cast<float*>(dg1r),
                            static_cast<float*>(dg2r)};
  float* dgi[kMaxGroups] = {static_cast<float*>(dg0i),
                            static_cast<float*>(dg1i),
                            static_cast<float*>(dg2i)};
  float* s_r = static_cast<float*>(sr);
  float* s_i = static_cast<float*>(si);
  float* c_r = static_cast<float*>(cr);
  float* c_i = static_cast<float*>(ci);
  float* t_r = static_cast<float*>(tr);
  float* t_i = static_cast<float*>(ti);
  float* scratch = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (1LL << wires) * batch;
  bool first_enc = true;
  for (int l = n_layers - 1; l >= 0; --l) {
    const int li = l % k;
    const int r = ring_range(li, wires);
    for (int g = grp.n - 1; g >= 0; --g) {
      const int dim = 1 << grp.size[g];
      const size_t gm = static_cast<size_t>(l) * dim * dim;
      const int sign = g == grp.n - 1 ? r : 0;
      // state in place: s_in = G^H s; cotangent into (t): G^H c
      err = launch_group<2>(s_r, s_i, s_r, s_i, c_r, c_i, t_r, t_i,
                            gr[g] + gm, gi[g] + gm, nullptr, nullptr, 0, 1,
                            sign, 0, grp.size[g], wires, grp.post_b[g], batch,
                            grp.ncols[g], s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_dg(c_r, c_i, s_r, s_i, scratch, dgr[g] + gm, dgi[g] + gm,
                      sign, grp.size[g], wires, grp.post_b[g], batch,
                      grp.ncols[g], s);
      if (err != cudaSuccess) return static_cast<int>(err);
      float* swap_r = c_r;
      float* swap_i = c_i;
      c_r = t_r;
      c_i = t_i;
      t_r = swap_r;
      t_i = swap_i;
    }
    if (li == 0) {
      const long long blocks = (n + 255) / 256;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      wide_unencode_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const float*>(pr), static_cast<const float*>(pi), s_r,
          s_i, c_r, c_i, static_cast<float*>(dpr), static_cast<float*>(dpi),
          n, first_enc ? 1 : 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      first_enc = false;
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
