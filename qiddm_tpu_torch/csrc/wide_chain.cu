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

namespace {

constexpr int kTile = 32;      // columns per block of the group product
constexpr int kChunk = 16;     // rows of op(G) staged at a time
constexpr int kDgK = 16;       // columns per step of the dG product
constexpr int kMaxGroups = 3;  // ceil(20 / 7)

// +1 or -1: the CZ ring of range r on basis row `row` of w wires; r = 0 is
// no ring.
__device__ __forceinline__ float ring_sign(unsigned row, int r, int wires) {
  if (r == 0) return 1.0f;
  const unsigned mask = (1u << wires) - 1u;
  const unsigned rot = ((row << r) | (row >> (wires - r))) & mask;
  return (__popc(row & rot) & 1) ? -1.0f : 1.0f;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Where column `col` of a group view lives: the flat offset of its row
// y = 0 and the basis row of that entry; row y adds y * postB to the offset
// and y * post to the basis row.
struct Column {
  long long base;      // (p D) postB + q
  unsigned row0;       // (p D) post + q / batch
};

__device__ __forceinline__ Column column_at(long long col, int dim,
                                            long long post_b, int batch) {
  const long long p = col / post_b;
  const long long q = col - p * post_b;
  const long long post = post_b / batch;
  Column c;
  c.base = p * dim * post_b + q;
  c.row0 = static_cast<unsigned>(p * dim * post + q / batch);
  return c;
}

// out_j = op(G) in_j on one group's axis, j < NRHS, op(G) = G or G^H.
// RX = D / (blockDim.x / 32) rows per thread. in0 may equal out0 (and in1
// out1): a block reads all of its columns before it writes any.
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
  const int dim = 1 << size;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = dim < kChunk ? dim : kChunk;
  float2* tile = smem2;                         // NRHS x [dim][kTile]
  float2* gch = smem2 + NRHS * dim * kTile;     // [chunk][dim]

  const long long col = static_cast<long long>(blockIdx.x) * kTile + lane;
  const bool valid = col < ncols;
  const Column c = column_at(valid ? col : 0, dim, post_b, batch);
  const long long post = post_b / batch;

  for (int y = warp; y < dim; y += nw) {
    const long long at = c.base + static_cast<long long>(y) * post_b;
    const unsigned row = c.row0 + static_cast<unsigned>(y * post);
    const float sg = ring_sign(row, sign_in, wires);
    float2 v = make_float2(0.0f, 0.0f);
    if (valid) {
      if (zero_in) {
        v.x = row == 0 ? 1.0f : 0.0f;
      } else {
        v = make_float2(in0r[at], in0i[at]);
      }
      if (phr != nullptr) v = cmul(v, make_float2(phr[at], phi[at]));
    }
    tile[y * kTile + lane] = make_float2(sg * v.x, sg * v.y);
    if (NRHS == 2) {
      const float2 w = valid ? make_float2(in1r[at], in1i[at])
                             : make_float2(0.0f, 0.0f);
      tile[(dim + y) * kTile + lane] = make_float2(sg * w.x, sg * w.y);
    }
  }

  float2 acc[NRHS][RX];
#pragma unroll
  for (int j = 0; j < NRHS; ++j)
#pragma unroll
    for (int i = 0; i < RX; ++i) acc[j][i] = make_float2(0.0f, 0.0f);

  for (int y0 = 0; y0 < dim; y0 += chunk) {
    __syncthreads();  // the tile is loaded; the last chunk is consumed
    for (int e = threadIdx.x; e < chunk * dim; e += blockDim.x) {
      int yy, x;
      float2 g;
      if (!adjoint) {  // op(G)[x][y] = G[x][y]
        yy = e % chunk;
        x = e / chunk;
        const int at = x * dim + y0 + yy;
        g = make_float2(gr[at], gi[at]);
      } else {         // op(G)[x][y] = conj(G[y][x])
        x = e % dim;
        yy = e / dim;
        const int at = (y0 + yy) * dim + x;
        g = make_float2(gr[at], -gi[at]);
      }
      gch[yy * dim + x] = g;
    }
    __syncthreads();
    for (int yy = 0; yy < chunk; ++yy) {
      float2 v[NRHS];
#pragma unroll
      for (int j = 0; j < NRHS; ++j)
        v[j] = tile[(j * dim + y0 + yy) * kTile + lane];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        const float2 g = gch[yy * dim + warp + nw * i];
#pragma unroll
        for (int j = 0; j < NRHS; ++j) {
          acc[j][i].x += g.x * v[j].x - g.y * v[j].y;
          acc[j][i].y += g.x * v[j].y + g.y * v[j].x;
        }
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int i = 0; i < RX; ++i) {
    const int x = warp + nw * i;
    const long long at = c.base + static_cast<long long>(x) * post_b;
    const unsigned row = c.row0 + static_cast<unsigned>(x * post);
    const float sg = ring_sign(row, sign_out, wires);
    out0r[at] = sg * acc[0][i].x;
    out0i[at] = sg * acc[0][i].y;
    if (NRHS == 2) {
      out1r[at] = acc[1][i].x;
      out1i[at] = acc[1][i].y;
    }
  }
}

// Partial dG[x][y] = sum over the split's columns of c[x] conj(s[y]), c
// times the ring signs of range sign_c. M x M complex sums per thread, a
// (16 M)-wide tile of dG per block (16 M <= 64; the whole of dG below 16
// rows, where the surplus threads idle). Block (tile, split) writes
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
  __shared__ float2 cs[kDgK][16 * M];
  __shared__ float2 ss[kDgK][16 * M];
  const int dim = 1 << size;
  const int tw = dim < 16 * M ? dim : 16 * M;  // tile edge
  const int tiles = dim / tw;
  const int t = blockIdx.x % (tiles * tiles);
  const long long split = blockIdx.x / (tiles * tiles);
  const int x0 = (t % tiles) * tw;
  const int y0 = (t / tiles) * tw;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long k_begin = split * per_split;
  long long k_end = k_begin + per_split;
  if (k_end > ncols) k_end = ncols;
  const long long post = post_b / batch;

  float2 acc[M][M];
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int b = 0; b < M; ++b) acc[a][b] = make_float2(0.0f, 0.0f);

  for (long long k0 = k_begin; k0 < k_end; k0 += kDgK) {
    for (int e = threadIdx.x; e < kDgK * tw; e += blockDim.x) {
      const int kk = e % kDgK;
      const int r = e / kDgK;
      const long long col = k0 + kk;
      float2 cv = make_float2(0.0f, 0.0f), sv = cv;
      if (col < k_end) {
        const Column c = column_at(col, dim, post_b, batch);
        const long long atx = c.base + static_cast<long long>(x0 + r) * post_b;
        const long long aty = c.base + static_cast<long long>(y0 + r) * post_b;
        const unsigned row =
            c.row0 + static_cast<unsigned>((x0 + r) * post);
        const float sg = ring_sign(row, sign_c, wires);
        cv = make_float2(sg * cr[atx], sg * ci[atx]);
        sv = make_float2(sr[aty], si[aty]);
      }
      cs[kk][r] = cv;
      ss[kk][r] = sv;
    }
    __syncthreads();
    if (tx < tw && ty < tw) {
      for (int kk = 0; kk < kDgK; ++kk) {
        float2 cv[M], sv[M];
#pragma unroll
        for (int a = 0; a < M; ++a) cv[a] = cs[kk][tx + 16 * a];
#pragma unroll
        for (int b = 0; b < M; ++b) sv[b] = ss[kk][ty + 16 * b];
#pragma unroll
        for (int a = 0; a < M; ++a)
#pragma unroll
          for (int b = 0; b < M; ++b) {  // c conj(s)
            acc[a][b].x += cv[a].x * sv[b].x + cv[a].y * sv[b].y;
            acc[a][b].y += cv[a].y * sv[b].x - cv[a].x * sv[b].y;
          }
      }
    }
    __syncthreads();
  }

  if (tx >= tw || ty >= tw) return;
  float* out = part + split * dim * dim * 2;
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int b = 0; b < M; ++b) {
      const int x = x0 + tx + 16 * a;
      const int y = y0 + ty + 16 * b;
      if (x < x0 + tw && y < y0 + tw) {
        out[(x * dim + y) * 2] = acc[a][b].x;
        out[(x * dim + y) * 2 + 1] = acc[a][b].y;
      }
    }
}

// dg[t] = sum over the splits of part[split][t], splits in increasing order.
__global__ void wide_dg_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dgr,
                                      float* __restrict__ dgi, int n,
                                      int nsplit) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float re = 0.0f, im = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float* p = part + (static_cast<size_t>(s) * n + t) * 2;
    re += p[0];
    im += p[1];
  }
  dgr[t] = re;
  dgi[t] = im;
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
  const float p_r = pr[i], p_i = pi[i];
  const float a = sr[i], b = si[i];
  const float x = cr[i], y = ci[i];
  const float s_r = a * p_r + b * p_i;  // state before the phase
  const float s_i = b * p_r - a * p_i;
  const float g_r = x * s_r + y * s_i;
  const float g_i = y * s_r - x * s_i;
  dpr[i] = first ? g_r : dpr[i] + g_r;
  dpi[i] = first ? g_i : dpi[i] + g_i;
  sr[i] = s_r;
  si[i] = s_i;
  cr[i] = x * p_r + y * p_i;
  ci[i] = y * p_r - x * p_i;
}

// Group geometry of one chain.
struct Groups {
  int n;
  int size[kMaxGroups];
  long long post_b[kMaxGroups];
  long long ncols[kMaxGroups];
};

Groups make_groups(const int* sizes, int wires, int batch) {
  Groups g;
  g.n = 0;
  int off = 0;
  for (int i = 0; i < kMaxGroups && sizes[i] > 0; ++i) {
    const int s = sizes[i];
    g.size[g.n] = s;
    g.post_b[g.n] = (1LL << (wires - off - s)) * batch;
    g.ncols[g.n] = (1LL << (wires - s)) * batch;
    off += s;
    ++g.n;
  }
  return g;
}

int ring_range(int li, int wires) {
  return wires > 1 ? li % (wires - 1) + 1 : 0;
}

int warps_for(int dim) { return dim < 8 ? dim : 8; }

size_t group_smem(int nrhs, int dim) {
  const int chunk = dim < kChunk ? dim : kChunk;
  return (static_cast<size_t>(nrhs) * dim * kTile +
          static_cast<size_t>(chunk) * dim) * sizeof(float2);
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

// The dG product's split: nsplit column ranges of per_split columns (a
// multiple of kDgK), about two blocks an SM over the tiles.
struct DgSplit {
  int tile_edge;
  int tiles;       // tiles of dG (tiles_per_edge^2)
  long long per_split;
  int nsplit;
};

DgSplit dg_split(int size, long long ncols) {
  const int dim = 1 << size;
  DgSplit d;
  d.tile_edge = dim < 64 ? dim : 64;
  d.tiles = (dim / d.tile_edge) * (dim / d.tile_edge);
  long long want = (264 + d.tiles - 1) / d.tiles;
  const long long most = (ncols + 63) / 64;  // at least 64 columns a split
  if (want > most) want = most;
  if (want < 1) want = 1;
  long long per = (ncols + want - 1) / want;
  per = (per + kDgK - 1) / kDgK * kDgK;
  d.per_split = per;
  d.nsplit = static_cast<int>((ncols + per - 1) / per);
  return d;
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
  if (dim >= 64) {
    wide_group_dg_kernel<4><<<grid, 256, 0, stream>>>(
        cr, ci, sr, si, part, sign_c, size, wires, post_b, batch, ncols,
        d.per_split);
  } else if (dim >= 32) {
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
