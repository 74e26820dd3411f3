// Pieces of the wide re-uploading chain shared by the per-group kernels
// (wide_chain.cu: #11 and #12, one launch per wire group) and the
// monolithic chain (wide_mono.cu: #9 and #10, one cooperative launch a
// chain): the ring signs, the column geometry of a group view, one 32-column
// tile of a group product, one unit of the dG product, the un-encode of one
// amplitude, and the host-side group geometry and dG split. Both kernels
// run these in the same order on the same tiles, so #9/#10 do #11/#12's
// arithmetic and give their numbers.
//
// Layout (see wide_chain.cu): (d, B) float32 planes, d = 2^w, wire 0 the
// most significant bit; the group at bit offset `off` and width `s` is the
// middle axis of a (2^off, 2^s, post B) view, post = 2^(w - off - s), and a
// group product is a complex (D x D) by (D x ncols) product over
// ncols = 2^(w-s) B columns.
//
// Everything here sits in an anonymous namespace, so each source that
// includes it gets its own copy and the library links without clashes.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

// Tile `tile` (columns tile*32 .. +31) of out_j = op(G) in_j on one group's
// axis, j < NRHS, op(G) = G or G^H. RX = D / (blockDim.x / 32) rows per
// thread. in0 may equal out0 (and in1 out1): the block reads all of its
// columns before it writes any. `smem` holds NRHS D x 32 tiles and a
// kChunk x D chunk of op(G) (group_smem()). Prologues: zero_in starts from
// |0...0> (no input read), phr/phi (when not null) multiply in the RZ phase,
// sign_in applies the ring signs of that range to every right-hand side;
// epilogue: sign_out on the first right-hand side. A caller that runs
// several tiles puts a __syncthreads() between them.
template <int NRHS, int RX>
__device__ __forceinline__ void group_tile(
    long long tile, float2* smem, const float* in0r, const float* in0i,
    float* out0r, float* out0i, const float* in1r, const float* in1i,
    float* out1r, float* out1i, const float* __restrict__ gr,
    const float* __restrict__ gi, const float* __restrict__ phr,
    const float* __restrict__ phi, int zero_in, int adjoint, int sign_in,
    int sign_out, int size, int wires, long long post_b, int batch,
    long long ncols) {
  const int dim = 1 << size;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = dim < kChunk ? dim : kChunk;
  float2* tl = smem;                          // NRHS x [dim][kTile]
  float2* gch = smem + NRHS * dim * kTile;    // [chunk][dim]

  const long long col = tile * kTile + lane;
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
    tl[y * kTile + lane] = make_float2(sg * v.x, sg * v.y);
    if (NRHS == 2) {
      const float2 w = valid ? make_float2(in1r[at], in1i[at])
                             : make_float2(0.0f, 0.0f);
      tl[(dim + y) * kTile + lane] = make_float2(sg * w.x, sg * w.y);
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
        v[j] = tl[(j * dim + y0 + yy) * kTile + lane];
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

// Unit `unit` of the dG product: a (16 M)-wide tile of
// dG[x][y] = sum over one split's columns of c[x] conj(s[y]), c times the
// ring signs of range sign_c. M x M complex sums per thread on a 16 x 16
// thread grid (the whole of dG below 16 rows, where the surplus threads
// idle); `cs` and `ss` are kDgK x 16 M float2 each in shared memory. Unit
// (tile t, split) = (unit % tiles^2, unit / tiles^2) writes
// part[split][x][y][re, im]. Ends on a __syncthreads().
template <int M>
__device__ __forceinline__ void dg_unit(long long unit, float2* cs,
                                        float2* ss, const float* cr,
                                        const float* ci, const float* sr,
                                        const float* si, float* part,
                                        int sign_c, int size, int wires,
                                        long long post_b, int batch,
                                        long long ncols,
                                        long long per_split) {
  constexpr int kW = 16 * M;
  const int dim = 1 << size;
  const int tw = dim < kW ? dim : kW;  // tile edge
  const int tiles = dim / tw;
  const int t = static_cast<int>(unit % (tiles * tiles));
  const long long split = unit / (tiles * tiles);
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
      cs[kk * kW + r] = cv;
      ss[kk * kW + r] = sv;
    }
    __syncthreads();
    if (tx < tw && ty < tw) {
      for (int kk = 0; kk < kDgK; ++kk) {
        float2 cv[M], sv[M];
#pragma unroll
        for (int a = 0; a < M; ++a) cv[a] = cs[kk * kW + tx + 16 * a];
#pragma unroll
        for (int b = 0; b < M; ++b) sv[b] = ss[kk * kW + ty + 16 * b];
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

// dg[t] = sum over the splits of part[split][t], splits in increasing
// order; n = D^2 entries.
__device__ __forceinline__ void dg_reduce_at(int t, const float* part,
                                             float* dgr, float* dgi, int n,
                                             int nsplit) {
  float re = 0.0f, im = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float* p = part + (static_cast<size_t>(s) * n + t) * 2;
    re += p[0];
    im += p[1];
  }
  dgr[t] = re;
  dgi[t] = im;
}

// Undo the RZ phase at amplitude i on the state and the cotangent (both in
// place) and add the phase gradient c conj(s_before) to (dpr, dpi); `first`
// writes it.
__device__ __forceinline__ void unencode_at(long long i, const float* pr,
                                            const float* pi, float* sr,
                                            float* si, float* cr, float* ci,
                                            float* dpr, float* dpi,
                                            int first) {
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

inline Groups make_groups(const int* sizes, int wires, int batch) {
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

// The CZ ring's range for sublayer li of a spectrum layer; 0 is no ring.
__host__ __device__ inline int ring_range(int li, int wires) {
  return wires > 1 ? li % (wires - 1) + 1 : 0;
}

inline int warps_for(int dim) { return dim < 8 ? dim : 8; }

inline size_t group_smem(int nrhs, int dim) {
  const int chunk = dim < kChunk ? dim : kChunk;
  return (static_cast<size_t>(nrhs) * dim * kTile +
          static_cast<size_t>(chunk) * dim) * sizeof(float2);
}

// The dG product's split: nsplit column ranges of per_split columns (a
// multiple of kDgK), about two blocks an SM over the tiles.
struct DgSplit {
  int tile_edge;
  int tiles;       // tiles of dG (tiles_per_edge^2)
  long long per_split;
  int nsplit;
};

inline DgSplit dg_split(int size, long long ncols) {
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

// M of dg_unit for a group of D = dim rows: 16 M-wide tiles of dG.
__host__ __device__ inline int dg_m(int dim) {
  return dim >= 64 ? 4 : dim >= 32 ? 2 : 1;
}

}  // namespace
