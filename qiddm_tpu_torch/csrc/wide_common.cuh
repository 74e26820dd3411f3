// Pieces of the wide re-uploading chain shared by the per-group kernels
// (wide_chain.cu: #11 and #12, one launch per wire group) and the
// monolithic chain (wide_mono.cu: #9 and #10, one cooperative launch a
// chain): the ring signs, the column geometry of a group view, the
// un-encode of one amplitude, the host-side group geometry, and the
// product units all four kernels run.
//
// The units are Hopper's: a persistent group product with op(G) resident
// in shared memory and the state tiles staged through a cp.async ring
// (group_mma), the dG product on the same path (dg_mma, under the split of
// dg_plan), both as 3xTF32 products on the tensor cores (mma.sync
// m16n8k8), and the fixed-order sum of dG's partials over the splits
// (dg_reduce_chunk). Both variants call the same units with the same tiles
// and splits, so a column's or a dG entry's sums run in one order: #9
// gives #11's bits and #10 gives #12's.
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
#include <cstdint>
#include <initializer_list>

namespace {

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

// ---------------------------------------------------------------------------
// The product units: 3xTF32 products on the tensor cores.
//
// A complex product out = A B runs in real form, [Ar -Ai; Ai Ar] against
// [Br; Bi]: out_r += Ar Br - Ai Bi and out_i += Ai Br + Ar Bi, four real
// products a 16 x 8 x 8 step. Each real product is mma.sync m16n8k8 in TF32
// three times: every operand x is split as its fragment is loaded from
// shared memory into hi = tf32(x) and lo = tf32(x - hi) (round to nearest,
// ties away), and a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi; the
// dropped a_lo b_lo is below 2^-22 |a b|. The large terms are summed
// outside the tensor cores (cmma_step). Shared memory holds float32 only.

constexpr int kMmaThreads = 256;  // 8 warps a block
constexpr int kStages = 2;        // the cp.async ring: tile t+1 in flight
constexpr int kDgTn = 32;         // columns a tile of the dG product
constexpr int kDgBlocks = 132;    // the dG units: about one an SM (H100)

// Column tiles of a group view. Rows mode (ppt == 0, post_b >= tn): each
// p-row of post_b columns is cut into per_p segments of at most tn columns.
// Blocks mode (post_b < tn): a tile is ppt whole p-blocks, one contiguous
// run of ppt D post_b floats. Either way a tile is a range of consecutive
// columns whose rows are runs of consecutive floats, copied `granule`
// floats (16, 8 or 4 bytes) at a time: the largest that post_b and the
// planes' alignment allow.
struct ColTiles {
  long long ntiles;
  long long per_p;
  int ppt;
  int granule;
};

inline ColTiles col_tiles(int tn, long long post_b, long long ncols,
                          bool aligned) {
  ColTiles c;
  c.granule = !aligned ? 1 : post_b % 4 == 0 ? 4 : post_b % 2 == 0 ? 2 : 1;
  const long long p_rows = ncols / post_b;
  if (post_b >= tn) {
    c.ppt = 0;
    c.per_p = (post_b + tn - 1) / tn;
    c.ntiles = p_rows * c.per_p;
  } else {
    c.ppt = static_cast<int>(tn / post_b);
    c.per_p = 0;
    c.ntiles = (p_rows + c.ppt - 1) / c.ppt;
  }
  return c;
}

// Whether every plane starts on 16 bytes, so rows may be copied 16 or 8
// bytes at a time.
inline bool aligned16(std::initializer_list<const void*> planes) {
  for (const void* p : planes)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Floats a copy of G's rows into shared memory.
inline int g_granule_for(int dim, bool aligned) {
  return !aligned ? 1 : dim < 4 ? dim : 4;
}

// Tile t's first column (into *col0) and its count of columns.
__device__ __forceinline__ int tile_span(const ColTiles& ct, int tn,
                                         long long t, long long post_b,
                                         long long ncols, long long* col0) {
  if (ct.ppt == 0) {
    const long long p = t / ct.per_p;
    const long long q0 = (t - p * ct.per_p) * tn;
    *col0 = p * post_b + q0;
    const long long left = post_b - q0;
    return left < tn ? static_cast<int>(left) : tn;
  }
  *col0 = t * ct.ppt * post_b;
  const long long left = ncols - *col0;
  const long long full = ct.ppt * post_b;
  return static_cast<int>(left < full ? left : full);
}

// Tile t's column table, written by threads 0..tn-1: base[j] the flat
// offset of row 0 of its column j, row[j] that entry's basis row (each
// column's two divisions once a tile, not once an element). Returns the
// tile's count of columns; the caller syncs before the table is read.
__device__ __forceinline__ int tile_table(const ColTiles& ct, int tn,
                                          long long t, int dim,
                                          long long post_b, int batch,
                                          long long ncols, long long* base,
                                          unsigned* row) {
  long long col0;
  const int n = tile_span(ct, tn, t, post_b, ncols, &col0);
  if (threadIdx.x < tn) {
    const int j = static_cast<int>(threadIdx.x) < n ? threadIdx.x : 0;
    const Column c = column_at(col0 + j, dim, post_b, batch);
    base[threadIdx.x] = c.base;
    row[threadIdx.x] = c.row0;
  }
  return n;
}

template <int N>
__device__ __forceinline__ void cp_async_n(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N)
                 : "memory");
  }
}

// Async copy of `granule` floats from global to shared memory; the copies
// a thread issues between two commits form one group.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int granule) {
  if (granule == 4) {
    cp_async_n<16>(dst, src);
  } else if (granule == 2) {
    cp_async_n<8>(dst, src);
  } else {
    cp_async_n<4>(dst, src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [r0, r0 + rows) of the columns j < n of a tile (table `base`)
// from each of the NP planes src[q] into shared planes `plane` floats apart,
// `ld` floats a row.
template <int NP>
__device__ __forceinline__ void stage_rows(float* dst, int plane, int ld,
                                           const float* const (&src)[NP],
                                           const long long* base, int r0,
                                           int rows, int n, int tn,
                                           long long post_b, int granule) {
  const int shift = __ffs(tn / granule) - 1;  // copies a row: a power of 2
  const int copies = rows << shift;
  for (int e = threadIdx.x; e < copies; e += blockDim.x) {
    const int r = e >> shift;
    const int j = (e - (r << shift)) * granule;
    if (j >= n) continue;
    const long long at = base[j] + static_cast<long long>(r0 + r) * post_b;
    float* d = dst + r * ld + j;
#pragma unroll
    for (int q = 0; q < NP; ++q) cp_async(d + q * plane, src[q] + at, granule);
  }
}

// Programmatic dependent launch (Hopper): a grid lets the next launch of
// its stream start (dependents_may_start, once every block has called it
// or exited), and that launch, where it carries
// cudaLaunchAttributeProgrammaticStreamSerialization, waits for this
// grid's completion and memory (wait_for_prior_grid) only before it
// touches the planes, so its start and its prologue hide behind this
// grid's tail. Without the attribute both are no-ops. The units call them
// where their template flag PDL is set (#11/#12); the monolith's passes,
// one cooperative launch that is never launched as a dependent, compile
// them out.
__device__ __forceinline__ void dependents_may_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The TF32 value nearest x, ties away from zero (cvt.rna.tf32.f32's
// rounding), by integer ops: half a TF32 ulp added to the magnitude bits,
// then the 13 low bits cleared.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 |x|, both TF32. lo keeps its 13 low bits
// after the half-ulp add: the tensor cores read a TF32 operand's top 19
// bits, which are lo rounded; the mask would only cost an instruction.
__device__ __forceinline__ void split_tf32(float x, unsigned* hi,
                                           unsigned* lo) {
  *hi = tf32_bits(x);
  *lo = __float_as_uint(x - __uint_as_float(*hi)) + 0x1000u;
}

struct FragA {  // a 16 x 8 operand of mma.m16n8k8, split
  unsigned hi[4], lo[4];
};
struct FragB {  // an 8 x 8 operand, split
  unsigned hi[2], lo[2];
};

// The A fragment of rows m0..m0+15, columns k0..k0+7 of a row-major array
// of `ld` floats a row (.row layout: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4), g = lane / 4, t = lane % 4).
__device__ __forceinline__ void load_a(FragA* f, const float* s, int ld,
                                       int m0, int k0, int lane) {
  const float* p = s + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], &f->hi[0], &f->lo[0]);
  split_tf32(p[8 * ld], &f->hi[1], &f->lo[1]);
  split_tf32(p[4], &f->hi[2], &f->lo[2]);
  split_tf32(p[8 * ld + 4], &f->hi[3], &f->lo[3]);
}

// The A fragment of the transpose of a row-major array: element (m, k) at
// k ld + m.
__device__ __forceinline__ void load_a_t(FragA* f, const float* s, int ld,
                                         int m0, int k0, int lane) {
  const float* p = s + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  split_tf32(p[0], &f->hi[0], &f->lo[0]);
  split_tf32(p[8], &f->hi[1], &f->lo[1]);
  split_tf32(p[4 * ld], &f->hi[2], &f->lo[2]);
  split_tf32(p[4 * ld + 8], &f->hi[3], &f->lo[3]);
}

// The B fragment (.col layout: b0 (k = t, n = g), b1 (t + 4, g)) of rows
// k0.., columns n0.. of a k-major array: element (k, n) at k ld + n.
__device__ __forceinline__ void load_b_kn(FragB* f, const float* s, int ld,
                                          int k0, int n0, int lane) {
  const float* p = s + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32(p[0], &f->hi[0], &f->lo[0]);
  split_tf32(p[4 * ld], &f->hi[1], &f->lo[1]);
}

// The same from an n-major array: element (k, n) at n ld + k.
__device__ __forceinline__ void load_b_nk(FragB* f, const float* s, int ld,
                                          int k0, int n0, int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], &f->hi[0], &f->lo[0]);
  split_tf32(p[4], &f->hi[1], &f->lo[1]);
}

__device__ __forceinline__ FragA negated(const FragA& a) {
  FragA n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    n.hi[i] = a.hi[i] ^ 0x80000000u;
    n.lo[i] = a.lo[i] ^ 0x80000000u;
  }
  return n;
}

__device__ __forceinline__ FragB negated(const FragB& b) {
  FragB n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    n.hi[i] = b.hi[i] ^ 0x80000000u;
    n.lo[i] = b.lo[i] ^ 0x80000000u;
  }
  return n;
}

// c += a b on one 16 x 8 x 8 TF32 step (c: c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1)).
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b on one step, from zero.
__device__ __forceinline__ void mma_tf32_new(float* c, const unsigned* a,
                                             const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// One 8-deep step of NB complex products sharing their A operand:
// (cr[n], ci[n]) += (ar + i ai)(br[n] + i bi[n]), nai = -ai, in 3xTF32.
// The tensor cores sum a step's products and round the sum toward zero,
// so each large step chained onto a sum pulls it toward zero by up to
// 2^-24 of it, and over a chain of unitary products the state's norm
// shrinks. So each large term (a_hi b_hi) is summed from zero on its own
// and added to the float32 sums (cr, ci) outside the tensor cores,
// rounding to nearest; the small terms (a_lo b_hi + a_hi b_lo), 2^-11 of
// the large ones, are summed in the tensor cores into (sr, si) over the
// whole product (the caller adds them at the end). With all six steps
// chained from zero, #12 at (16, 10, 28) lay 1e-5 from its plain version
// on an H100, and 3.4e-5 at (9, 80, 28) with the whole product chained;
// 2e-5 is allowed.
template <int NB>
__device__ __forceinline__ void cmma_step(float (&cr)[NB][4],
                                          float (&ci)[NB][4],
                                          float (&sr)[NB][4],
                                          float (&si)[NB][4],
                                          const FragA& ar, const FragA& ai,
                                          const FragA& nai,
                                          const FragB (&br)[NB],
                                          const FragB (&bi)[NB]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32(sr[n], ar.lo, br[n].hi);
    mma_tf32(si[n], ai.lo, br[n].hi);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32(sr[n], ar.hi, br[n].lo);
    mma_tf32(si[n], ai.hi, br[n].lo);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32(sr[n], nai.lo, bi[n].hi);
    mma_tf32(si[n], ar.lo, bi[n].hi);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32(sr[n], nai.hi, bi[n].lo);
    mma_tf32(si[n], ar.hi, bi[n].lo);
  }
  float p[NB][4], q[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32_new(p[n], ar.hi, br[n].hi);
    mma_tf32_new(q[n], nai.hi, bi[n].hi);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) cr[n][i] = cr[n][i] + p[n][i] + q[n][i];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    mma_tf32_new(p[n], ai.hi, br[n].hi);
    mma_tf32_new(q[n], ar.hi, bi[n].hi);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) ci[n][i] = ci[n][i] + p[n][i] + q[n][i];
}

// c[n] += s[n], the small terms' sums into the large ones'.
template <int NB>
__device__ __forceinline__ void add_small(float (&c)[NB][4],
                                          const float (&s)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] += s[n][i];
}

// Shape of group_mma for NRHS right-hand sides and DP = max(16, D) rows.
// 8 warps: kWm over the rows (16 each), kWn over the kTn columns of a tile
// (kNt steps of 8 each). Shared memory: the column tables of kStages tiles,
// G as two planes of DP rows of DP + 4 floats (G) or DP + 8 (G^H, read
// transposed), and kStages stages of 2 NRHS planes of DP x kLd. The pads
// put a warp's fragment loads on 32 distinct banks (G: g ld + t, ld = 4
// mod 32; G^H: t ld + g, ld = 8 mod 32; the state: t kLd + g, kLd = 8 mod
// 32), but for two right-hand sides at D = 128, where the state's pad
// does not fit the 227 KB and its loads go 2-way.
template <int NRHS, int DP>
struct MmaShape {
  static constexpr int kTn = DP == 16 ? 64 : DP == 32 ? 32 : 32 / NRHS;
  static constexpr int kLd = kTn + (DP == 128 && NRHS == 2 ? 0 : 8);
  static constexpr int kWm = DP / 16 < 8 ? DP / 16 : 8;
  static constexpr int kWn = 8 / kWm;
  static constexpr int kNt = kTn / kWn / 8;
  static constexpr int kGld = DP + 8;  // the larger of the two pads
  static constexpr int kPlane = DP * kLd;
  static constexpr int kStage = 2 * NRHS * kPlane;
  static constexpr size_t kSmem =
      (3 * kStages * kTn + 2 * DP * kGld + kStages * kStage) * sizeof(float);
};

// The group product out_j = op(G) in_j, j < NRHS, op(G) = G or G^H, on the
// tensor cores (3xTF32), by a persistent block: it stages G into shared
// memory once (cp.async, with its first tile; G^H is G read transposed and
// conjugated), then walks the column tiles blockIdx.x, + gridDim.x, ... of
// `ct`, each tile's copies issued two tiles ahead, so tile t+1 is in
// flight while tile t is multiplied. The tiles are disjoint and a
// block writes only columns it alone reads, so in0 may equal out0 (and in1
// out1). Prologues on a tile in shared memory: zero_in starts from
// |0...0> (no input read), phr/phi (when not null) multiply in the RZ
// phase, sign_in applies the ring signs of that range to every right-hand
// side; epilogue: sign_out on the first right-hand side. A block with no
// tile stages G and drains its copies all the same.
template <int NRHS, int DP, bool PDL = true>
__device__ __forceinline__ void group_mma(
    float* smem, const float* in0r, const float* in0i, float* out0r,
    float* out0i, const float* in1r, const float* in1i, float* out1r,
    float* out1i, const float* __restrict__ gr, const float* __restrict__ gi,
    const float* __restrict__ phr, const float* __restrict__ phi,
    int zero_in, int adjoint, int sign_in, int sign_out, int size, int wires,
    long long post_b, int batch, long long ncols, ColTiles ct,
    int g_granule) {
  using S = MmaShape<NRHS, DP>;
  constexpr int TN = S::kTn, LD = S::kLd, PLANE = S::kPlane;
  const int dim = 1 << size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gld = DP + (adjoint ? 8 : 4);
  long long* cbase = reinterpret_cast<long long*>(smem);  // [kStages][TN]
  unsigned* crow = reinterpret_cast<unsigned*>(cbase + kStages * TN);
  float* gs = smem + 3 * kStages * TN;  // G: [re, im][DP][gld]
  float* st = gs + 2 * DP * S::kGld;    // [kStages][NRHS][re, im][DP][LD]
  const long long post = post_b / batch;

  // G's rows, g_granule floats a copy, in the first tile's copy group;
  // zero past D
  {
    const int per_row = dim / g_granule;
    for (int e = tid; e < 2 * dim * per_row; e += blockDim.x) {
      const int q = e / (dim * per_row);  // 0: re, 1: im
      const int a = (e - q * dim * per_row) / per_row;
      const int b = (e - q * dim * per_row - a * per_row) * g_granule;
      cp_async(gs + (q * DP + a) * gld + b, (q ? gi : gr) + a * dim + b,
               g_granule);
    }
    if (dim < DP)
      for (int e = tid; e < 2 * DP * DP; e += blockDim.x) {
        const int a = (e / DP) % DP;
        const int b = e % DP;
        if (a >= dim || b >= dim) gs[(e / DP) * gld + b] = 0.0f;
      }
  }
  // rows D..DP-1 of the staged planes stay 0 (groups below 16 rows)
  if (dim < DP) {
    const int pad = (DP - dim) * LD;
    for (int e = tid; e < kStages * 2 * NRHS * pad; e += blockDim.x) {
      const int q = e / pad;
      st[q * PLANE + dim * LD + e - q * pad] = 0.0f;
    }
  }

  const float* src[2 * NRHS];
  src[0] = in0r;
  src[1] = in0i;
  if constexpr (NRHS == 2) {
    src[2] = in1r;
    src[3] = in1i;
  }
  float* outr[NRHS];
  float* outi[NRHS];
  outr[0] = out0r;
  outi[0] = out0i;
  if constexpr (NRHS == 2) {
    outr[1] = out1r;
    outi[1] = out1i;
  }
  const long long step = gridDim.x;
  auto issue = [&](long long t, int s) {
    if (t < ct.ntiles) {  // uniform over the block
      const int n = tile_table(ct, TN, t, dim, post_b, batch, ncols,
                               cbase + s * TN, crow + s * TN);
      __syncthreads();
      if (!zero_in)
        stage_rows<2 * NRHS>(st + s * S::kStage, PLANE, LD, src,
                             cbase + s * TN, 0, dim, n, TN, post_b,
                             ct.granule);
    }
    cp_async_commit();
  };

  if constexpr (PDL) wait_for_prior_grid();  // G is an input: staged before
  issue(blockIdx.x, 0);
  issue(blockIdx.x + step, 1);
  const int m0 = (warp % S::kWm) * 16;
  const int n0 = (warp / S::kWm) * (TN / S::kWn);
  int s = 0;
  for (long long t = blockIdx.x; t < ct.ntiles; t += step, s ^= 1) {
    cp_async_wait<1>();  // tile t's copies have landed
    __syncthreads();
    long long col0;
    const int n = tile_span(ct, TN, t, post_b, ncols, &col0);
    float* tile = st + s * S::kStage;
    const long long* base = cbase + s * TN;
    const unsigned* row = crow + s * TN;
    if (zero_in || phr != nullptr || sign_in != 0) {
      for (int e = tid; e < dim * TN; e += blockDim.x) {
        const int y = e / TN;
        const int j = e - y * TN;
        if (j >= n) continue;
        const unsigned r = row[j] + static_cast<unsigned>(y * post);
        const float sg = ring_sign(r, sign_in, wires);
        float* p = tile + y * LD + j;
        float2 v = zero_in ? make_float2(r == 0 ? 1.0f : 0.0f, 0.0f)
                           : make_float2(p[0], p[PLANE]);
        if (phr != nullptr) {
          const long long at = base[j] + static_cast<long long>(y) * post_b;
          v = cmul(v, make_float2(phr[at], phi[at]));
        }
        p[0] = sg * v.x;
        p[PLANE] = sg * v.y;
        if constexpr (NRHS == 2) {
          p[2 * PLANE] *= sg;
          p[3 * PLANE] *= sg;
        }
      }
      __syncthreads();
    }

    // product b = j kNt + nt: right-hand side j, 8-column step nt
    constexpr int NB = NRHS * S::kNt;
    float acr[NB][4], aci[NB][4], asr[NB][4], asi[NB][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acr[b][i] = aci[b][i] = asr[b][i] = asi[b][i] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < DP; k0 += 8) {
      FragA ar, ai, nai;
      if (adjoint) {  // op(G)[x][y] = conj(G[y][x])
        load_a_t(&ar, gs, gld, m0, k0, lane);
        load_a_t(&nai, gs + DP * gld, gld, m0, k0, lane);
        ai = negated(nai);
      } else {
        load_a(&ar, gs, gld, m0, k0, lane);
        load_a(&ai, gs + DP * gld, gld, m0, k0, lane);
        nai = negated(ai);
      }
      FragB br[NB], bi[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = b / S::kNt;
        const int col = n0 + 8 * (b % S::kNt);
        load_b_kn(&br[b], tile + 2 * j * PLANE, LD, k0, col, lane);
        load_b_kn(&bi[b], tile + (2 * j + 1) * PLANE, LD, k0, col, lane);
      }
      cmma_step<NB>(acr, aci, asr, asi, ar, ai, nai, br, bi);
    }
    add_small<NB>(acr, asr);
    add_small<NB>(aci, asi);

    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int j = 0; j < NRHS; ++j)
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = m0 + g + 8 * h;
          const int c = n0 + 8 * nt + 2 * tq;
          if (x >= dim || c >= n) continue;
          const int b = j * S::kNt + nt;
          float re0 = acr[b][2 * h], im0 = aci[b][2 * h];
          float re1 = acr[b][2 * h + 1], im1 = aci[b][2 * h + 1];
          const long long xo = static_cast<long long>(x) * post_b;
          if (j == 0 && sign_out != 0) {
            const unsigned xr = static_cast<unsigned>(x * post);
            const float s0 = ring_sign(row[c] + xr, sign_out, wires);
            re0 *= s0;
            im0 *= s0;
            if (c + 1 < n) {
              const float s1 = ring_sign(row[c + 1] + xr, sign_out, wires);
              re1 *= s1;
              im1 *= s1;
            }
          }
          if (ct.granule >= 2) {  // c even: c, c + 1 adjacent, 8-byte aligned
            const long long at = base[c] + xo;
            *reinterpret_cast<float2*>(outr[j] + at) = make_float2(re0, re1);
            *reinterpret_cast<float2*>(outi[j] + at) = make_float2(im0, im1);
          } else {
            outr[j][base[c] + xo] = re0;
            outi[j][base[c] + xo] = im0;
            if (c + 1 < n) {
              outr[j][base[c + 1] + xo] = re1;
              outi[j][base[c + 1] + xo] = im1;
            }
          }
        }
    __syncthreads();  // stage s and its table are free
    issue(t + 2 * step, s);
  }
  // the next launch's blocks may take this SM now, not at entry: blocks
  // of waiting launches crowd the SMs and unbalance the next grid
  if constexpr (PDL) dependents_may_start();
  cp_async_wait<0>();
}

// Shape of dg_mma for a TW x TW tile of dG: 8 warps, kWm over its rows x
// (16 each), kWn over its columns y (kNt steps of 8); idle warps (TW = 16)
// only copy. A stage holds c's rows x and s's rows y of one kDgTn-column
// tile, kLd = 4 mod 32 floats a row, so both operands' fragment loads (g
// on the rows, t on the columns) fall on 32 distinct banks.
template <int TW>
struct DgShape {
  static constexpr int kLd = kDgTn + 4;
  static constexpr int kWm = TW / 16;
  static constexpr int kWn = 8 / kWm < TW / 8 ? 8 / kWm : TW / 8;
  static constexpr int kNt = TW / kWn / 8;
  static constexpr int kPlane = TW * kLd;
  static constexpr int kStage = 4 * kPlane;  // c re, c im, s re, s im
  static constexpr size_t kSmem =
      (3 * kStages * kDgTn + kStages * kStage) * sizeof(float);
};

// Unit `unit` of the dG product on the tensor cores (3xTF32): a TW x TW
// tile of dG[x][y] = sum over one split's column tiles of c[x] conj(s[y]),
// c times the ring signs of range sign_c; unit (tile o, split) =
// (unit % tiles, unit / tiles) writes part[split][x][y][re, im]. The
// split's tiles go through the cp.async ring as in group_mma; columns past
// a tile's end are zero in both operands. Every thread returns with its
// copies drained; the unit's last use of shared memory is behind a
// __syncthreads().
template <int TW, bool PDL = true>
__device__ __forceinline__ void dg_mma(float* smem, long long unit,
                                       const float* cr, const float* ci,
                                       const float* sr, const float* si,
                                       float* part, int sign_c, int size,
                                       int wires, long long post_b, int batch,
                                       long long ncols, ColTiles ct,
                                       long long per_split) {
  using S = DgShape<TW>;
  constexpr int TN = kDgTn, LD = S::kLd, PLANE = S::kPlane;
  const int dim = 1 << size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int edge = dim > TW ? dim / TW : 1;
  const int o = static_cast<int>(unit % (edge * edge));
  const long long split = unit / (edge * edge);
  const int x0 = (o % edge) * TW;
  const int y0 = (o / edge) * TW;
  const int rows = dim < TW ? dim : TW;
  long long* cbase = reinterpret_cast<long long*>(smem);
  unsigned* crow = reinterpret_cast<unsigned*>(cbase + kStages * TN);
  float* st = smem + 3 * kStages * TN;  // [kStages][c re, c im, s re, s im]
  const long long post = post_b / batch;
  const long long t0 = split * per_split;
  const long long t1 =
      t0 + per_split < ct.ntiles ? t0 + per_split : ct.ntiles;
  const float* const csrc[2] = {cr, ci};
  const float* const ssrc[2] = {sr, si};

  auto issue = [&](long long t, int s) {
    if (t < t1) {  // uniform over the block
      const int n = tile_table(ct, TN, t, dim, post_b, batch, ncols,
                               cbase + s * TN, crow + s * TN);
      __syncthreads();
      float* tile = st + s * S::kStage;
      stage_rows<2>(tile, PLANE, LD, csrc, cbase + s * TN, x0, rows, n, TN,
                    post_b, ct.granule);
      stage_rows<2>(tile + 2 * PLANE, PLANE, LD, ssrc, cbase + s * TN, y0,
                    rows, n, TN, post_b, ct.granule);
      if (n < TN)
        for (int e = tid; e < rows * TN; e += blockDim.x) {
          const int r = e / TN;
          const int j = e - r * TN;
          if (j < n) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) tile[q * PLANE + r * LD + j] = 0.0f;
        }
    }
    cp_async_commit();
  };

  if constexpr (PDL) wait_for_prior_grid();
  issue(t0, 0);
  issue(t0 + 1, 1);
  const bool active = warp < S::kWm * S::kWn;
  const int m0 = (warp % S::kWm) * 16;
  const int n0 = (warp / S::kWm) * (TW / S::kWn);
  constexpr int NB = S::kNt;
  float acr[NB][4], aci[NB][4], asr[NB][4], asi[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acr[n][i] = aci[n][i] = asr[n][i] = asi[n][i] = 0.0f;
  int s = 0;
  for (long long t = t0; t < t1; ++t, s ^= 1) {
    cp_async_wait<1>();
    __syncthreads();
    float* tile = st + s * S::kStage;
    if (sign_c != 0) {  // zero columns stay zero
      const unsigned* row = crow + s * TN;
      for (int e = tid; e < rows * TN; e += blockDim.x) {
        const int r = e / TN;
        const int j = e - r * TN;
        const float sg = ring_sign(
            row[j] + static_cast<unsigned>((x0 + r) * post), sign_c, wires);
        tile[r * LD + j] *= sg;
        tile[PLANE + r * LD + j] *= sg;
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int k0 = 0; k0 < TN; k0 += 8) {
        FragA ar, ai;
        load_a(&ar, tile, LD, m0, k0, lane);
        load_a(&ai, tile + PLANE, LD, m0, k0, lane);
        const FragA nai = negated(ai);
        FragB br[NB], bi[NB];  // conj(s): the imaginary part negated
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          load_b_nk(&br[n], tile + 2 * PLANE, LD, k0, n0 + 8 * n, lane);
          load_b_nk(&bi[n], tile + 3 * PLANE, LD, k0, n0 + 8 * n, lane);
          bi[n] = negated(bi[n]);
        }
        cmma_step<NB>(acr, aci, asr, asi, ar, ai, nai, br, bi);
      }
    }
    __syncthreads();  // stage s and its table are free
    issue(t + 2, s);
  }
  if constexpr (PDL) dependents_may_start();
  cp_async_wait<0>();
  if (!active) return;
  add_small<NB>(acr, asr);
  add_small<NB>(aci, asi);
  float* out = part + split * dim * dim * 2;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = x0 + m0 + g + 8 * h;
        const int y = y0 + n0 + 8 * nt + 2 * tq + c;
        if (x < dim && y < dim)
          *reinterpret_cast<float2*>(out + (x * dim + y) * 2) =
              make_float2(acr[nt][2 * h + c], aci[nt][2 * h + c]);
      }
}

// dG's split on the tensor-core path: TW x TW tiles of dG (TW = min(64,
// max(16, D))), each over nsplit ranges of per_split column tiles of kDgTn
// columns, about kDgBlocks units: the tensor cores of an SM set a unit's
// pace, so one unit an SM, each a near-equal share.
struct DgPlan {
  int tw;
  int otiles;
  ColTiles ct;
  long long per_split;
  int nsplit;
};

inline DgPlan dg_plan(int size, long long post_b, long long ncols,
                      bool aligned) {
  const int dim = 1 << size;
  DgPlan d;
  d.tw = dim >= 64 ? 64 : dim >= 32 ? 32 : 16;
  const int edge = dim > d.tw ? dim / d.tw : 1;
  d.otiles = edge * edge;
  d.ct = col_tiles(kDgTn, post_b, ncols, aligned);
  long long want = kDgBlocks / d.otiles;
  if (want > d.ct.ntiles) want = d.ct.ntiles;
  if (want < 1) want = 1;
  d.per_split = (d.ct.ntiles + want - 1) / want;
  d.nsplit = static_cast<int>((d.ct.ntiles + d.per_split - 1) / d.per_split);
  return d;
}

// dg[t] = sum over the splits of part[split][t] for the 32 entries
// t = 32 chunk + lane of one chunk, by a block of kMmaThreads threads:
// each of the 8 warps sums the splits w, w + 8, ... in order, then the
// first warp adds the 8 sums in order; the order is fixed, so is every
// bit. `sums` holds 8 x 32 float2 of shared memory; a caller that runs
// several chunks puts a __syncthreads() between them. part is read with
// plain loads: the monolith wrote it in the same launch.
__device__ __forceinline__ void dg_reduce_chunk(int chunk, const float2* part,
                                                float* dgr, float* dgi,
                                                int n, int nsplit,
                                                float2* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = chunk * 32 + lane;
  float2 acc = make_float2(0.0f, 0.0f);
  if (t < n)
    for (int s = warp; s < nsplit; s += 8) {
      const float2 p = part[static_cast<size_t>(s) * n + t];
      acc.x += p.x;
      acc.y += p.y;
    }
  sums[warp * 32 + lane] = acc;
  __syncthreads();
  if (warp == 0 && t < n) {
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      re += sums[w * 32 + lane].x;
      im += sums[w * 32 + lane].y;
    }
    dgr[t] = re;
    dgi[t] = im;
  }
}

}  // namespace
