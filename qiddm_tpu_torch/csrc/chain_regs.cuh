// The register-resident bodies of the re-uploading chains, for NVIDIA
// Hopper (sm_90a): the adjoint walk of kernel #2 (gate_chain.cu, RZ phase
// encode) and kernel #4 (ry_chain.cu, RY encode), the forward of kernels
// #1 and #3 (chain_fwd, below the walk) on the walk's layout, and the SEL
// chain's forward #5 and adjoint #6 (sel_fwd, sel_walk, at the end; for
// sel_chain.cu) on the same layout and units.
//
// What the walk computes: from the forward output and its cotangent,
// l = n_layers-1 .. 0, the CZ signs of layer l, then for j = w-1 .. 0 the
// adjoint gate on the state, the gate's dg (output-side cotangent against
// the gate's input state) and the adjoint gate on the cotangent; at
// l % k == 0 the encode is undone (RZ: the phase,
// with the phase gradient; RY: w adjoint encode gates, with the sample's
// encode gradient dc_j = dg[0] + dg[6], ds_j = dg[4] - dg[2]). dg is summed
// over the batch. Wire 0 is the most significant bit, d = 2^w.
//
// What bounds it. The work is tiny (~40 d flops a gate and sample) and
// serial: 168 gates in a row at (w=6, L*k=28), each needing the last one's
// state. So a sample's walk is a chain of short latency-bound steps, and one
// warp alone on its scheduler issues it: the time is a gate's latency and
// instruction count. A reduction of dg over the sample's rows at every
// gate (a shuffle tree and a barrier) would lie on that path, as would
// state kept in shared memory. The design keeps a gate's critical path to
// its 2x2 arithmetic and one exchange, takes the dg reduction off that
// path, and gives each sample its own warp(s):
//   * Layout. Up to 7 wires a warp owns a sample, at 8 wires two warps, from
//     9 four. Index i = (h << (LB + WB)) | (warp << LB) | lane: LB =
//     min(w, 5) lane bits, WB warp bits, the rest register bits, so a
//     thread holds A = 2^(w - LB - WB) amplitudes (2 at 6 wires, 4 at 7-9,
//     8 at 10) of the state and of the cotangent (and, for RZ, of the phase
//     column and its gradient) in registers for the whole walk. Below 5
//     wires lanes d..31 hold nothing.
//   * Gates. A register bit pairs amplitudes inside a thread; a lane bit
//     swaps the partner's values with __shfl_xor_sync; a warp bit swaps
//     them through a double-buffered shared-memory plane behind a named
//     barrier over that sample's warps only (bar.sync id, threads). Each
//     thread of a pair forms only its own new row and the two entries of
//     dg that pair that row with both rows' cotangents. A gate's 8
//     scalars are loaded from shared memory one gate ahead. Below 8 wires a
//     layer's gates are unrolled; from 8 the lane and warp bits run as a
//     loop over one body, which keeps a layer's code in the instruction
//     cache (fully unrolled, the 8-wire layer's code outgrew it and ran
//     slower).
//   * No reduction a gate. Each thread writes its 8 dg partials of a gate
//     to its row of a shared-memory strip (two 16-byte stores; a row stride
//     whose quarter is odd: no bank conflicts) and goes on; once a layer,
//     between two barriers of the sample (__syncwarp for one warp), thread
//     c sums dg[l]'s entry c down its strip column over the rows in a fixed
//     order (walk_flush, walk_column; every load of it in flight) into the
//     sample's dg[l]. The RY encode's (dc, ds) partials go through the same
//     strip, once a re-upload.
//   * Samples and the batch sum. chain_bwd_plan (sim/gate_kernel.py) puts
//     S <= 4 samples a CTA (2 from 8 wires) and up to 8 CTAs a thread-block
//     cluster. At the end each CTA sums its samples' dg in increasing b
//     after one block barrier; after a cluster barrier every CTA adds a
//     share of the entries over the cluster's CTAs, read from their shared
//     memory (distributed shared memory), in rank order: for a batch that
//     one cluster holds (32 samples, 16 from 8 wires) dg is final in the
//     launch. A larger batch writes one sum a cluster, and the wrapper's
//     fixed-order dg_batch_sum_kernel adds them. No atomics: two calls give
//     the same bits.
//   * Tables. The gate scalars and the k sign planes are copied into each
//     CTA's shared memory once and read by broadcast (gates) or by lane
//     (signs). A sample's column of the (d, B) planes is read and written
//     with each thread's A loads in flight together; with at most 4 samples
//     a CTA a row of the CTA's samples is one 32-byte sector, so staging the
//     columns through shared memory would not coalesce further.
//
// The forward (chain_fwd<W, RY>) runs the chain from |0...0> on the same
// layout, state only: a gate on a register bit is gate_pair on the
// thread's pairs; on a lane bit 2 shuffles an amplitude (the partner's sr,
// si), on a warp bit 2 planes through the sample's exchange buffers behind
// its named barrier; each thread forms only its own new row, in
// gate_pair's fmaf order. The CZ signs become, once a CTA, one 32-bit mask
// a rank and sign plane of the rows whose sign is -1, read once a layer and
// applied as a sign flip (the same bits as the product with -1). The RZ
// phase is A complex products in registers; the RY encode's coefficients
// are read by broadcast from shared memory. Samples are independent: no
// cluster, no reduction, and after the tables are staged no block barrier;
// chain_fwd_plan (sim/gate_kernel.py) sets the samples a CTA.
//
// The SEL chain (sel_fwd, sel_walk) runs on arbitrary start states, with no
// encode, and puts a ring of range l % (w-1) + 1 after every layer's gates.
// A CZ ring is a sign flip of each thread's rows computed from the row
// index (cz_mask: no table). A CNOT ring is a permutation, linear over
// GF(2): each thread writes its amplitudes to the sample's exchange planes,
// passes one barrier of the sample, and reads the rows of the gather map,
// the XOR of its (p, w) columns over the row's set bits (ring_gather). The
// widths run to 12 wires: 8 warps a sample at 11 and 16 at 12 (A = 8);
// there the walk sums each gate's dg partials over the warp's lanes first
// (warp_dg_store), so the strip holds a row a warp and not a row a thread
// (512 rows x 100 floats would not fit beside the 128 KB of exchange
// planes).
//
// Everything here sits in an anonymous namespace, as in chain_common.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace {

// Warps a sample at `wires` wires: 1 up to 7 wires, 2 at 8, 4 at 9-10, 8
// at 11 and 16 at 12 (the SEL chain's widths).
__host__ __device__ constexpr int walk_warps(int wires) {
  return wires < 8 ? 1 : wires == 8 ? 2 : wires <= 10 ? 4 : wires == 11 ? 8
                                                                        : 16;
}

// Samples a CTA at most: 4 up to 7 wires, 2 at 8-10, 1 from 11.
__host__ __device__ constexpr int walk_max_samples(int wires) {
  return wires < 8 ? 4 : wires <= 10 ? 2 : 1;
}

// The layout at W wires (see the notes above).
template <int W>
struct WalkShape {
  static constexpr int D = 1 << W;
  static constexpr int LB = W < 5 ? W : 5;   // lane bits of the index
  static constexpr int WB = walk_warps(W) == 16  ? 4
                            : walk_warps(W) == 8 ? 3
                            : walk_warps(W) == 4 ? 2
                                                 : walk_warps(W) / 2;
  static constexpr int A = 1 << (W - LB - WB);  // amplitudes a thread
  static constexpr int WARPS = 1 << WB;       // warps a sample
  static constexpr int T = 32 * WARPS;        // threads a sample
  // from 11 wires a gate's dg partials are summed over the warp's lanes
  // before the strip (warp_dg_store): a strip row a warp
  static constexpr bool WARP_DG = W >= 11;
  static constexpr int STRIP_ROWS = WARP_DG ? WARPS : T;
  // the strip rows that hold partials: threads that hold amplitudes
  static constexpr int ROWS = WARP_DG ? WARPS : D < T ? D : T;
  static constexpr int NC = 8 * W;            // dg columns a layer
  // strip row stride: a multiple of 4 floats whose quarter is odd, so the
  // 16-byte stores of 8 lanes hit 8 different bank groups
  static constexpr int STRIDE = NC + 4;
  static constexpr int MAX_SAMPLES = walk_max_samples(W);
  static constexpr int MAX_THREADS = MAX_SAMPLES * T;
};

constexpr int kWalkMaxCluster = 8;  // CTAs a cluster (portable)

// Offsets, in floats, of a CTA's shared-memory regions (the gate scalars at
// 0), each region a multiple of 4 floats so float4 copies stay aligned.
struct WalkLayout {
  size_t sg, enc, strip, dgs, xbuf, floats;
};

__host__ __device__ inline size_t walk_round4(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);
}

__host__ __device__ inline WalkLayout walk_layout(int wires, int n_layers,
                                                  int k, int samples,
                                                  bool ry) {
  const size_t d = static_cast<size_t>(1) << wires;
  const size_t t = 32 * walk_warps(wires);
  const size_t stride = static_cast<size_t>(8 * wires) + 4;
  const size_t nd = static_cast<size_t>(n_layers) * wires * 8;
  WalkLayout o;
  o.sg = walk_round4(nd);
  o.enc = o.sg + walk_round4(static_cast<size_t>(k) * d);
  o.strip = o.enc + (ry ? walk_round4(static_cast<size_t>(samples) * 2 *
                                      wires)
                        : 0);
  o.dgs = o.strip + walk_round4(samples * t * stride);
  o.xbuf = o.dgs + walk_round4(samples * nd);
  o.floats = o.xbuf + (walk_warps(wires) > 1 ? samples * 8 * d : 0);
  return o;
}

// The index of a thread's amplitude h.
template <int W>
__device__ __forceinline__ int walk_index(int h, int r) {
  return (h << (WalkShape<W>::LB + WalkShape<W>::WB)) | r;
}

// The barrier of one sample's threads: __syncwarp for one warp, else the
// named barrier 1 + slot over its warps (0 is __syncthreads').
template <int W>
__device__ __forceinline__ void walk_sync(int slot) {
  if constexpr (WalkShape<W>::WARPS == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(WalkShape<W>::T)
                 : "memory");
  }
}

// The strip row of the thread of rank r: its own, or from 11 wires its
// warp's.
template <int W>
__device__ __forceinline__ int walk_row(int r) {
  return WalkShape<W>::WARP_DG ? r >> 5 : r;
}

// A gate's 8 dg partials p summed over the warp's 32 lanes into row[0..7]:
// a reduce-scatter over lane bits 4, 3 and 2 (each level keeps half of the
// entries and adds the partner's), after which lane l holds entry
// (l >> 2) & 7 over 8 lanes, then a sum over lane bits 0 and 1; lanes with
// l & 3 == 0 write their entry. 9 shuffles, a fixed order.
__device__ __forceinline__ void warp_dg_store(const float (&p)[8],
                                              float* row) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float v4[4], v2[2];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v4[e] = (b4 ? p[e + 4] : p[e]) +
            __shfl_xor_sync(0xffffffffu, b4 ? p[e] : p[e + 4], 16);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    v2[e] = (b3 ? v4[e + 2] : v4[e]) +
            __shfl_xor_sync(0xffffffffu, b3 ? v4[e] : v4[e + 2], 8);
  float v = (b2 ? v2[1] : v2[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? v2[0] : v2[1], 4);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if ((lane & 3) == 0) row[(lane >> 2) & 7] = v;
}

// Runs step(h, o) for each of a thread's amplitudes h, for a gate on index
// bit `bit` below the register bits, where v(p, h) is this thread's value
// of plane p and o[p] its partner's: by warp shuffle for a lane bit, one
// amplitude at a time, and through the sample's exchange planes (two sets
// of NP x d floats used in turn, so one barrier an exchange) for a warp bit.
template <int W, int NP, typename Value, typename Step>
__device__ __forceinline__ void plane_exchange(Value v, int bit, int r,
                                               int slot, float* xbuf,
                                               int& xpar, Step step) {
  using Sh = WalkShape<W>;
  if (Sh::WB == 0 || bit < Sh::LB) {
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      float o[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        o[p] = __shfl_xor_sync(0xffffffffu, v(p, h), 1 << bit);
      step(h, o);
    }
  } else {
    float* xb = xbuf + xpar * NP * Sh::D;
    xpar ^= 1;  // the next exchange writes the other set
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      const int i = walk_index<W>(h, r);
#pragma unroll
      for (int p = 0; p < NP; ++p) xb[p * Sh::D + i] = v(p, h);
    }
    walk_sync<W>(slot);
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      const int i = walk_index<W>(h, r) ^ (1 << bit);
      float o[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) o[p] = xb[p * Sh::D + i];
      step(h, o);
    }
  }
}

// plane_exchange of the walk's four planes: step(h, the partner's sr, si,
// cr, ci).
template <int W, typename Step>
__device__ __forceinline__ void walk_exchange(
    const float (&sr)[WalkShape<W>::A], const float (&si)[WalkShape<W>::A],
    const float (&cr)[WalkShape<W>::A], const float (&ci)[WalkShape<W>::A],
    int bit, int r, int slot, float* xbuf, int& xpar, Step step) {
  plane_exchange<W, 4>(
      [&](int p, int h) {
        return p == 0 ? sr[h] : p == 1 ? si[h] : p == 2 ? cr[h] : ci[h];
      },
      bit, r, slot, xbuf, xpar,
      [&](int h, const float (&o)[4]) { step(h, o[0], o[1], o[2], o[3]); });
}

// One adjoint step for the gate (ma, mb) = its 8 scalars on index bit
// `bit`: the adjoint gate on the state and on the cotangent, and this
// thread's dg partials written to row[0..7] (16-byte aligned; from 11
// wires the warp's sum of them, by warp_dg_store). REG: `bit`
// is a register bit, known at compile time: the thread holds whole pairs
// and writes dg's 8 entries in order. Else a lane or warp bit, which may
// vary at run time (one body serves every such bit): the thread holds row
// x of each pair and forms only its new row; with the partner's cotangent
// (which came with the exchange) it writes the two entries of dg that pair
// both rows' cotangents with that row, (dg[x][x], dg[1-x][x]), to floats
// 4x..4x+3 and zeros to the other four (walk_flush maps them back).
template <int W, bool REG>
__device__ __forceinline__ void walk_gate(
    float (&sr)[WalkShape<W>::A], float (&si)[WalkShape<W>::A],
    float (&cr)[WalkShape<W>::A], float (&ci)[WalkShape<W>::A],
    float4 ma, float4 mb, int bit, int r, int slot, float* xbuf, int& xpar,
    float* row) {
  using Sh = WalkShape<W>;
  constexpr int A = Sh::A;
  // the adjoint gate: a_xy = conj(g_yx)
  const float a00r = ma.x, a00i = -ma.y, a10r = ma.z, a10i = -ma.w;
  const float a01r = mb.x, a01i = -mb.y, a11r = mb.z, a11i = -mb.w;
  if constexpr (REG) {  // pairs in this thread
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = 0.0f;
    const int rb = 1 << (bit - Sh::LB - Sh::WB);
#pragma unroll
    for (int h = 0; h < A; ++h) {
      if (h & rb) continue;
      const int h1 = h | rb;
      const float s0r = sr[h], s0i = si[h], s1r = sr[h1], s1i = si[h1];
      const float c0r = cr[h], c0i = ci[h], c1r = cr[h1], c1i = ci[h1];
      const float t0r = a00r * s0r - a00i * s0i + a01r * s1r - a01i * s1i;
      const float t0i = a00r * s0i + a00i * s0r + a01r * s1i + a01i * s1r;
      const float t1r = a10r * s0r - a10i * s0i + a11r * s1r - a11i * s1i;
      const float t1i = a10r * s0i + a10i * s0r + a11r * s1i + a11i * s1r;
      p[0] += c0r * t0r + c0i * t0i;  // dg00
      p[1] += c0i * t0r - c0r * t0i;
      p[2] += c0r * t1r + c0i * t1i;  // dg01
      p[3] += c0i * t1r - c0r * t1i;
      p[4] += c1r * t0r + c1i * t0i;  // dg10
      p[5] += c1i * t0r - c1r * t0i;
      p[6] += c1r * t1r + c1i * t1i;  // dg11
      p[7] += c1i * t1r - c1r * t1i;
      sr[h] = t0r;
      si[h] = t0i;
      sr[h1] = t1r;
      si[h1] = t1i;
      cr[h] = a00r * c0r - a00i * c0i + a01r * c1r - a01i * c1i;
      ci[h] = a00r * c0i + a00i * c0r + a01r * c1i + a01i * c1r;
      cr[h1] = a10r * c0r - a10i * c0i + a11r * c1r - a11i * c1i;
      ci[h1] = a10r * c0i + a10i * c0r + a11r * c1i + a11i * c1r;
    }
    if constexpr (Sh::WARP_DG) {
      warp_dg_store(p, row);
    } else {
      reinterpret_cast<float4*>(row)[0] = make_float4(p[0], p[1], p[2], p[3]);
      reinterpret_cast<float4*>(row)[1] = make_float4(p[4], p[5], p[6], p[7]);
    }
  } else {  // a lane or warp bit: the partner thread holds the other row
    const int x = (r >> bit) & 1;  // this thread's bit of the pair
    // its new row: t_x = a_xx own + a_x(1-x) other
    const float ur = x ? a11r : a00r, ui = x ? a11i : a00i;
    const float vr = x ? a10r : a01r, vi = x ? a10i : a01i;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, q3 = 0.0f;
    walk_exchange<W>(sr, si, cr, ci, bit, r, slot, xbuf, xpar,
                     [&](int h, float osr, float osi, float ocr, float oci) {
      const float tr = ur * sr[h] - ui * si[h] + vr * osr - vi * osi;
      const float ti = ur * si[h] + ui * sr[h] + vr * osi + vi * osr;
      q0 += cr[h] * tr + ci[h] * ti;  // dg[x][x]: its own cotangent
      q1 += ci[h] * tr - cr[h] * ti;
      q2 += ocr * tr + oci * ti;      // dg[1-x][x]: the partner's
      q3 += oci * tr - ocr * ti;
      const float nr = ur * cr[h] - ui * ci[h] + vr * ocr - vi * oci;
      const float ni = ur * ci[h] + ui * cr[h] + vr * oci + vi * ocr;
      sr[h] = tr;
      si[h] = ti;
      cr[h] = nr;
      ci[h] = ni;
    });
    if constexpr (Sh::WARP_DG) {
      const float p[8] = {x ? 0.0f : q0, x ? 0.0f : q1, x ? 0.0f : q2,
                          x ? 0.0f : q3, x ? q0 : 0.0f, x ? q1 : 0.0f,
                          x ? q2 : 0.0f, x ? q3 : 0.0f};
      warp_dg_store(p, row);
    } else {
      reinterpret_cast<float4*>(row)[x] = make_float4(q0, q1, q2, q3);
      reinterpret_cast<float4*>(row)[x ^ 1] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}
// One adjoint encode step RY(-x_j) = [[c, s], [-s, c]] on index bit `bit`
// (a real gate, on the real and the imaginary plane alike): this thread's
// (dc, ds) partials of the sample's encode gradient go to row[0..1]. REG as
// for walk_gate.
template <int W, bool REG>
__device__ __forceinline__ void walk_encode(
    float (&sr)[WalkShape<W>::A], float (&si)[WalkShape<W>::A],
    float (&cr)[WalkShape<W>::A], float (&ci)[WalkShape<W>::A], float c,
    float s, int bit, int r, int slot, float* xbuf, int& xpar, float* row) {
  using Sh = WalkShape<W>;
  constexpr int A = Sh::A;
  float dc = 0.0f, ds = 0.0f;
  if constexpr (REG) {
    const int rb = 1 << (bit - Sh::LB - Sh::WB);
#pragma unroll
    for (int h = 0; h < A; ++h) {
      if (h & rb) continue;
      const int h1 = h | rb;
      const float t0r = c * sr[h] + s * sr[h1], t0i = c * si[h] + s * si[h1];
      const float t1r = c * sr[h1] - s * sr[h], t1i = c * si[h1] - s * si[h];
      dc += (cr[h] * t0r + ci[h] * t0i) + (cr[h1] * t1r + ci[h1] * t1i);
      ds += (cr[h1] * t0r + ci[h1] * t0i) - (cr[h] * t1r + ci[h] * t1i);
      const float n0r = c * cr[h] + s * cr[h1], n0i = c * ci[h] + s * ci[h1];
      const float n1r = c * cr[h1] - s * cr[h], n1i = c * ci[h1] - s * ci[h];
      sr[h] = t0r;
      si[h] = t0i;
      sr[h1] = t1r;
      si[h1] = t1i;
      cr[h] = n0r;
      ci[h] = n0i;
      cr[h1] = n1r;
      ci[h1] = n1i;
    }
  } else {
    const bool x = (r >> bit) & 1;
    // its new row: c own + so other
    const float so = x ? -s : s;
    walk_exchange<W>(sr, si, cr, ci, bit, r, slot, xbuf, xpar,
                     [&](int h, float osr, float osi, float ocr, float oci) {
      const float tr = c * sr[h] + so * osr, ti = c * si[h] + so * osi;
      dc += cr[h] * tr + ci[h] * ti;
      // the partner's cotangent against this row: ds takes + c1.t0 from
      // the thread of bit 0 and - c0.t1 from the thread of bit 1
      ds -= ocr * tr + oci * ti;
      const float nr = c * cr[h] + so * ocr, ni = c * ci[h] + so * oci;
      sr[h] = tr;
      si[h] = ti;
      cr[h] = nr;
      ci[h] = ni;
    });
    ds = x ? ds : -ds;
  }
  *reinterpret_cast<float2*>(row) = make_float2(dc, ds);
}

// Column c of the strip summed over the sample's rows in a fixed order: four
// running sums over the rows 4m + u (u = 0..3, m increasing), then
// (sum0 + sum1) + (sum2 + sum3). Unrolled, so every load is in flight.
template <int W>
__device__ __forceinline__ float walk_column(const float* strip, int c) {
  using Sh = WalkShape<W>;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int row = 0; row < Sh::ROWS; ++row)
    acc[row & 3] += strip[row * Sh::STRIDE + c];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// dg[l] from the strip, between two barriers of the sample: out[c] for this
// thread's entries c = r, r + T, ... < 8W, each a strip column summed over
// all rows as walk_column sums it, the columns side by side so that all
// their loads are in flight. Entry e of a register bit's gate j is column
// 8j + e; a lane or warp bit's gate holds (dg00, dg10) in its floats 0-3
// and (dg11, dg01) in 4-7, zeros where the thread's bit differs.
template <int W>
__device__ __forceinline__ void walk_flush(const float* strip, int r,
                                           int slot, float* out) {
  using Sh = WalkShape<W>;
  constexpr int CR = (Sh::NC + Sh::T - 1) / Sh::T;  // columns a thread
  walk_sync<W>(slot);  // every row of the strip is written
  int src[CR];
#pragma unroll
  for (int q = 0; q < CR; ++q) {
    const int c = r + q * Sh::T;
    src[q] = c;
    const int j = c >> 3, e = c & 7, x = (e >> 1) & 1;
    if (W - 1 - j < Sh::LB + Sh::WB)
      src[q] = j * 8 + x * 4 + ((e & 1) | ((((e >> 2) ^ x) & 1) << 1));
  }
  float acc[CR][4];
#pragma unroll
  for (int q = 0; q < CR; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[q][u] = 0.0f;
#pragma unroll
  for (int row = 0; row < Sh::ROWS; ++row)
#pragma unroll
    for (int q = 0; q < CR; ++q)
      if (r + q * Sh::T < Sh::NC)
        acc[q][row & 3] += strip[row * Sh::STRIDE + src[q]];
#pragma unroll
  for (int q = 0; q < CR; ++q) {
    const int c = r + q * Sh::T;
    if (c < Sh::NC)
      out[c] = (acc[q][0] + acc[q][1]) + (acc[q][2] + acc[q][3]);
  }
  walk_sync<W>(slot);  // every column is read before the strip is rewritten
}

// The adjoint gates of layer l, wire j = W-1 .. 0 (index bit 0 first: the
// lane and warp bits, then each register bit), each gate's dg partials to
// the thread's strip row (walk_row), columns 8j..8j+7. (na, nb) hold gate
// (l, W-1)'s scalars on entry and the next gate's, (l-1, W-1), on exit:
// each gate's scalars are loaded one gate ahead. The lane and warp bits'
// gates are unrolled while a layer's code is small; from 8 wires one body
// in a loop serves them all, which keeps a layer's code in the
// instruction cache.
template <int W>
__device__ __forceinline__ void walk_layer(
    float (&sr)[WalkShape<W>::A], float (&si)[WalkShape<W>::A],
    float (&cr)[WalkShape<W>::A], float (&ci)[WalkShape<W>::A],
    const float* g, int l, float4& na, float4& nb, int r, int slot,
    float* xbuf, int& xpar, float* strip) {
  using Sh = WalkShape<W>;
  constexpr int XB = Sh::LB + Sh::WB;  // the bits below the register bits
  auto xgate = [&](int bit) {
    const int j = W - 1 - bit;
    const float4 ma = na, mb = nb;
    // gate (l, j - 1), or at j = 0 the next layer's (l - 1, W - 1)
    const int next = l * W + j - 1;
    if (next >= 0) {
      na = *reinterpret_cast<const float4*>(g + next * 8);
      nb = *reinterpret_cast<const float4*>(g + next * 8 + 4);
    }
    walk_gate<W, false>(sr, si, cr, ci, ma, mb, bit, r, slot, xbuf, xpar,
                        strip + walk_row<W>(r) * Sh::STRIDE + j * 8);
  };
  if constexpr (W < 8) {
#pragma unroll
    for (int bit = 0; bit < XB; ++bit) xgate(bit);
  } else {
#pragma unroll 1
    for (int bit = 0; bit < XB; ++bit) xgate(bit);
  }
#pragma unroll
  for (int bit = XB; bit < W; ++bit) {
    const int j = W - 1 - bit;
    const float4 ma = na, mb = nb;
    const int next = l * W + j - 1;
    if (next >= 0) {
      na = *reinterpret_cast<const float4*>(g + next * 8);
      nb = *reinterpret_cast<const float4*>(g + next * 8 + 4);
    }
    walk_gate<W, true>(sr, si, cr, ci, ma, mb, bit, r, slot, xbuf, xpar,
                       strip + walk_row<W>(r) * Sh::STRIDE + j * 8);
  }
}

// dg over the batch, at the end of a walk: this CTA's samples' dg (dgs,
// samples x nd floats, the CTA's first sample b0) in increasing b, then the
// cluster's CTAs in rank order, read from their shared memory; dg_out
// receives the cluster's sum at dg_out + cluster * nd. Every thread of the
// CTA calls it, with the cluster's handle taken at the walk's start.
__device__ __forceinline__ void walk_batch_sum(
    cooperative_groups::cluster_group& cluster, float* dgs, int nd,
    int samples, int batch, int b0, float* dg_out) {
  __syncthreads();
  const int nlive = min(samples, batch - b0);
  for (int i = threadIdx.x; i < nd && nlive > 1; i += blockDim.x) {
    float v = dgs[i];
    for (int s = 1; s < nlive; ++s) v += dgs[static_cast<size_t>(s) * nd + i];
    dgs[i] = v;
  }
  cluster.sync();  // every CTA's sum is whole
  {
    // every CTA adds a share of the entries over the live ranks, in rank
    // order, with the ranks' loads in flight together
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int first = b0 - rank * samples;  // the cluster's first sample
    const int ranks = min(csize, (batch - first + samples - 1) / samples);
    float* dst = dg_out + static_cast<size_t>(blockIdx.x / csize) * nd;
    const float* part[kWalkMaxCluster];
#pragma unroll
    for (int q = 0; q < kWalkMaxCluster; ++q)
      part[q] = cluster.map_shared_rank(dgs, q < ranks ? q : 0);
    for (int i = rank * blockDim.x + threadIdx.x; i < nd;
         i += csize * blockDim.x) {
      float v[kWalkMaxCluster];
#pragma unroll
      for (int q = 0; q < kWalkMaxCluster; ++q)
        v[q] = q < ranks ? part[q][i] : 0.0f;
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < kWalkMaxCluster; ++q)
        if (q < ranks) sum += v[q];
      dst[i] = sum;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The walk of one CTA. RZ (RY false): ea, eb are the phase planes pr, pi
// (d, B), ga, gb receive dpr, dpi (d, B). RY: ea is cs (2w, B), eb unused,
// ga receives dcs (2w, B). dg_out receives dg (n_layers, w, 8) summed over
// this cluster's samples, at dg_out + cluster * n_layers * w * 8. It writes
// out the layer's gates and dg's batch sum that sel_walk calls as
// walk_layer and walk_batch_sum: as functions here they moved ptxas's
// register counts of 4 of #2/#4's 40 width instances and slowed #2 at 6
// wires by a quarter.
template <int W, bool RY>
__device__ __forceinline__ void adjoint_walk(
    const float* __restrict__ ea, const float* __restrict__ eb,
    const float* __restrict__ g8, const float* __restrict__ signs,
    const float* __restrict__ fr, const float* __restrict__ fi,
    const float* __restrict__ gr, const float* __restrict__ gi,
    float* __restrict__ dg_out, float* __restrict__ ga,
    float* __restrict__ gb, int batch, int n_layers, int k) {
  namespace cg = cooperative_groups;
  using Sh = WalkShape<W>;
  constexpr int D = Sh::D, A = Sh::A, T = Sh::T, NC = Sh::NC;
  constexpr int XB = Sh::LB + Sh::WB;  // the bits below the register bits
  // the lane and warp bits' gates unrolled while a layer's code is small;
  // from 8 wires one body in a loop serves them all, which keeps a layer's
  // code in the instruction cache
  constexpr bool UNROLL = W < 8;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int samples = blockDim.x / T;
  const int slot = threadIdx.x / T;  // the sample's slot in the CTA
  const int r = threadIdx.x % T;     // the thread's rank in the sample
  const int b0 = blockIdx.x * samples;
  const int b = b0 + slot;
  const bool live = b < batch;
  const bool holds = live && r < D;  // below 5 wires lanes d..31 hold none
  const WalkLayout lay = walk_layout(W, n_layers, k, samples, RY);
  const int nd = n_layers * NC;
  float* g = smem;
  float* sg = smem + lay.sg;
  float* enc = smem + lay.enc + static_cast<size_t>(slot) * 2 * W;
  float* strip = smem + lay.strip + static_cast<size_t>(slot) * T * Sh::STRIDE;
  float* dgs = smem + lay.dgs;
  float* mydg = dgs + static_cast<size_t>(slot) * nd;
  float* xbuf = smem + lay.xbuf + static_cast<size_t>(slot) * 8 * D;

  // the read-only tables, once a CTA
  if ((reinterpret_cast<uintptr_t>(g8) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(g8);
    float4* dst = reinterpret_cast<float4*>(g);
    for (int i = threadIdx.x; i < nd / 4; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < nd; i += blockDim.x) g[i] = g8[i];
  }
  for (int i = threadIdx.x; i < k * D; i += blockDim.x) sg[i] = signs[i];
  if constexpr (RY) {
    for (int i = threadIdx.x; i < samples * 2 * W; i += blockDim.x) {
      const int bb = b0 + i / (2 * W);
      smem[lay.enc + i] =
          bb < batch ? ea[static_cast<size_t>(i % (2 * W)) * batch + bb]
                     : 0.0f;
    }
  }

  // the sample's column, in registers for the whole walk
  float sr[A], si[A], cr[A], ci[A];
  float phr[A], phi[A], acr[A], aci[A];  // RZ: the phase and its gradient
#pragma unroll
  for (int h = 0; h < A; ++h) {
    const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
    sr[h] = holds ? fr[at] : 0.0f;
    si[h] = holds ? fi[at] : 0.0f;
    cr[h] = holds ? gr[at] : 0.0f;
    ci[h] = holds ? gi[at] : 0.0f;
    if constexpr (!RY) {
      phr[h] = holds ? ea[at] : 0.0f;
      phi[h] = holds ? eb[at] : 0.0f;
      acr[h] = 0.0f;
      aci[h] = 0.0f;
    }
  }
  __syncthreads();  // the tables are in place

  float enc_acc = 0.0f;  // RY: thread r < 2w carries dc (r even) or ds
  if (live) {
    int xpar = 0;
    // the next gate's scalars, loaded one gate ahead
    float4 na = *reinterpret_cast<const float4*>(g + (nd - 8));
    float4 nb = *reinterpret_cast<const float4*>(g + (nd - 4));
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* sgl = sg + (l % k) * D;
#pragma unroll
      for (int h = 0; h < A; ++h) {
        const float f = sgl[walk_index<W>(h, r) & (D - 1)];
        sr[h] *= f;
        si[h] *= f;
        cr[h] *= f;
        ci[h] *= f;
      }
#pragma unroll
      // wire j = W-1-bit, last first: the lane and warp bits, then each
      // register bit
      auto xgate = [&](int bit) {
        const int j = W - 1 - bit;
        const float4 ma = na, mb = nb;
        // gate (l, j - 1), or at j = 0 the next layer's (l - 1, W - 1)
        const int next = l * W + j - 1;
        if (next >= 0) {
          na = *reinterpret_cast<const float4*>(g + next * 8);
          nb = *reinterpret_cast<const float4*>(g + next * 8 + 4);
        }
        walk_gate<W, false>(sr, si, cr, ci, ma, mb, bit, r, slot, xbuf, xpar,
                            strip + r * Sh::STRIDE + j * 8);
      };
      if constexpr (UNROLL) {
#pragma unroll
        for (int bit = 0; bit < XB; ++bit) xgate(bit);
      } else {
#pragma unroll 1
        for (int bit = 0; bit < XB; ++bit) xgate(bit);
      }
#pragma unroll
      for (int bit = XB; bit < W; ++bit) {
        const int j = W - 1 - bit;
        const float4 ma = na, mb = nb;
        const int next = l * W + j - 1;
        if (next >= 0) {
          na = *reinterpret_cast<const float4*>(g + next * 8);
          nb = *reinterpret_cast<const float4*>(g + next * 8 + 4);
        }
        walk_gate<W, true>(sr, si, cr, ci, ma, mb, bit, r, slot, xbuf, xpar,
                           strip + r * Sh::STRIDE + j * 8);
      }
      walk_flush<W>(strip, r, slot, mydg + l * NC);
      if (l % k == 0) {
        if constexpr (RY) {
          auto xencode = [&](int bit) {
            const int j = W - 1 - bit;
            walk_encode<W, false>(sr, si, cr, ci, enc[j], enc[W + j], bit, r,
                                  slot, xbuf, xpar,
                                  strip + r * Sh::STRIDE + 2 * j);
          };
          if constexpr (UNROLL) {
#pragma unroll
            for (int bit = 0; bit < XB; ++bit) xencode(bit);
          } else {
#pragma unroll 1
            for (int bit = 0; bit < XB; ++bit) xencode(bit);
          }
#pragma unroll
          for (int bit = XB; bit < W; ++bit) {
            const int j = W - 1 - bit;
            walk_encode<W, true>(sr, si, cr, ci, enc[j], enc[W + j], bit, r,
                                 slot, xbuf, xpar,
                                 strip + r * Sh::STRIDE + 2 * j);
          }
          walk_sync<W>(slot);  // every row of the strip is written
          if (r < 2 * W) enc_acc += walk_column<W>(strip, r);
          walk_sync<W>(slot);
        } else {
#pragma unroll
          for (int h = 0; h < A; ++h) {
            const float p_r = phr[h], p_i = phi[h];
            const float a = sr[h], c = si[h];
            const float x = cr[h], y = ci[h];
            const float spr = a * p_r + c * p_i;  // state before the phase
            const float spi = c * p_r - a * p_i;
            acr[h] += x * spr + y * spi;
            aci[h] += y * spr - x * spi;
            sr[h] = spr;
            si[h] = spi;
            cr[h] = x * p_r + y * p_i;
            ci[h] = y * p_r - x * p_i;
          }
        }
      }
    }
    if constexpr (RY) {
      if (r < 2 * W) {
        const int j = r >> 1;
        ga[static_cast<size_t>((r & 1) ? W + j : j) * batch + b] = enc_acc;
      }
    } else {
#pragma unroll
      for (int h = 0; h < A; ++h) {
        const size_t at =
            static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
        if (holds) {
          ga[at] = acr[h];
          gb[at] = aci[h];
        }
      }
    }
  }

  // dg over the batch: this CTA's samples in increasing b, then the
  // cluster's CTAs in rank order, read from their shared memory
  __syncthreads();
  const int nlive = min(samples, batch - b0);
  for (int i = threadIdx.x; i < nd && nlive > 1; i += blockDim.x) {
    float v = dgs[i];
    for (int s = 1; s < nlive; ++s) v += dgs[static_cast<size_t>(s) * nd + i];
    dgs[i] = v;
  }
  cluster.sync();  // every CTA's sum is whole
  {
    // every CTA adds a share of the entries over the live ranks, in rank
    // order, with the ranks' loads in flight together
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int first = b0 - rank * samples;  // the cluster's first sample
    const int ranks = min(csize, (batch - first + samples - 1) / samples);
    float* dst = dg_out + static_cast<size_t>(blockIdx.x / csize) * nd;
    const float* part[kWalkMaxCluster];
#pragma unroll
    for (int q = 0; q < kWalkMaxCluster; ++q)
      part[q] = cluster.map_shared_rank(dgs, q < ranks ? q : 0);
    for (int i = rank * blockDim.x + threadIdx.x; i < nd;
         i += csize * blockDim.x) {
      float v[kWalkMaxCluster];
#pragma unroll
      for (int q = 0; q < kWalkMaxCluster; ++q)
        v[q] = q < ranks ? part[q][i] : 0.0f;
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < kWalkMaxCluster; ++q)
        if (q < ranks) sum += v[q];
      dst[i] = sum;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// Offsets, in floats, of a forward CTA's shared-memory regions (the gate
// scalars at 0), each a multiple of 4 floats: the k sign masks of each of
// the T ranks of a sample (one 32-bit word a rank and plane), the RY encode
// coefficients of each sample (2w floats), and, from 8 wires, each sample's
// two sets of exchange planes (2 x 2 x d floats).
struct FwdLayout {
  size_t masks, enc, xbuf, floats;
};

__host__ __device__ inline FwdLayout fwd_layout(int wires, int n_layers,
                                                int k, int samples, bool ry) {
  const size_t d = static_cast<size_t>(1) << wires;
  const size_t t = 32 * walk_warps(wires);
  FwdLayout o;
  o.masks = walk_round4(static_cast<size_t>(n_layers) * wires * 8);
  o.enc = o.masks + walk_round4(static_cast<size_t>(k) * t);
  o.xbuf = o.enc + (ry ? walk_round4(static_cast<size_t>(samples) * 2 *
                                     wires)
                       : 0);
  o.floats = o.xbuf + (walk_warps(wires) > 1 ? samples * 4 * d : 0);
  return o;
}

// The 2x2 gate (ma, mb) = (g00, g01 | g10, g11) on this thread's row x of a
// pair, (orr, oi) the partner's row: t_x = g_x0 b0 + g_x1 b1, (b0, b1) the
// pair's rows of bit 0 and 1, each output's products summed in gate_pair's
// fmaf order, so the rounding is that of the other chain kernels.
__device__ __forceinline__ void fwd_row(float4 ma, float4 mb, bool x,
                                        float& sr, float& si, float orr,
                                        float oi) {
  const float4 q = x ? mb : ma;
  const float b0r = x ? orr : sr, b0i = x ? oi : si;
  const float b1r = x ? sr : orr, b1i = x ? si : oi;
  sr = fmaf(-q.w, b1i, fmaf(q.z, b1r, fmaf(-q.y, b0i, q.x * b0r)));
  si = fmaf(q.w, b1r, fmaf(q.z, b1i, fmaf(q.y, b0r, q.x * b0i)));
}

// The forward gate (ma, mb) on index bit `bit`. REG: a register bit, whose
// pairs lie in the thread (gate_pair on each); else a lane or warp bit, the
// partner's row fetched by plane_exchange and only this thread's new row
// formed.
template <int W, bool REG>
__device__ __forceinline__ void fwd_gate(float (&sr)[WalkShape<W>::A],
                                         float (&si)[WalkShape<W>::A],
                                         float4 ma, float4 mb, int bit, int r,
                                         int slot, float* xbuf, int& xpar) {
  using Sh = WalkShape<W>;
  if constexpr (REG) {
    const float m[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
    const int rb = 1 << (bit - Sh::LB - Sh::WB);
#pragma unroll
    for (int h = 0; h < Sh::A; ++h)
      if (!(h & rb)) gate_pair(m, sr[h], si[h], sr[h | rb], si[h | rb]);
  } else {
    const bool x = (r >> bit) & 1;
    plane_exchange<W, 2>(
        [&](int p, int h) { return p == 0 ? sr[h] : si[h]; }, bit, r, slot,
        xbuf, xpar, [&](int h, const float (&o)[2]) {
          fwd_row(ma, mb, x, sr[h], si[h], o[0], o[1]);
        });
  }
}

// The encode RY(x) = [[c, -s], [s, c]] on index bit `bit`, a real gate on
// both planes, in gate_pair's order for the 8-float gate (c, 0, -s, 0, s, 0,
// c, 0) less its zero products: row 0 gets fmaf(-s, b1, c b0), row 1
// fmaf(c, b1, s b0). REG as for fwd_gate.
template <int W, bool REG>
__device__ __forceinline__ void fwd_encode(float (&sr)[WalkShape<W>::A],
                                           float (&si)[WalkShape<W>::A],
                                           float c, float s, int bit, int r,
                                           int slot, float* xbuf, int& xpar) {
  using Sh = WalkShape<W>;
  if constexpr (REG) {
    const int rb = 1 << (bit - Sh::LB - Sh::WB);
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      if (h & rb) continue;
      const int h1 = h | rb;
      const float a0r = sr[h], a0i = si[h], a1r = sr[h1], a1i = si[h1];
      sr[h] = fmaf(-s, a1r, c * a0r);
      si[h] = fmaf(-s, a1i, c * a0i);
      sr[h1] = fmaf(c, a1r, s * a0r);
      si[h1] = fmaf(c, a1i, s * a0i);
    }
  } else {
    const bool x = (r >> bit) & 1;
    const float q0 = x ? s : c, q1 = x ? c : -s;
    plane_exchange<W, 2>(
        [&](int p, int h) { return p == 0 ? sr[h] : si[h]; }, bit, r, slot,
        xbuf, xpar, [&](int h, const float (&o)[2]) {
          const float b0r = x ? o[0] : sr[h], b0i = x ? o[1] : si[h];
          const float b1r = x ? sr[h] : o[0], b1i = x ? si[h] : o[1];
          sr[h] = fmaf(q1, b1r, q0 * b0r);
          si[h] = fmaf(q1, b1i, q0 * b0i);
        });
  }
}

// Starts copying the n-float gate table g8 (n a multiple of 4) into
// shared memory at dst (16-byte aligned): by cp.async, 16 bytes a copy,
// every copy in flight, when g8 is 16-byte aligned (returns true: the
// caller waits with stage_wait before its barrier), else by plain loads.
__device__ __forceinline__ bool stage_gates(float* dst,
                                            const float* __restrict__ g8,
                                            int n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(g8) & 15) == 0;
  if (aligned) {
    const unsigned base =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       base + 16 * i),
                   "l"(g8 + 4 * i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = g8[i];
  }
  return aligned;
}

__device__ __forceinline__ void stage_wait(bool aligned) {
  if (aligned) asm volatile("cp.async.wait_all;" ::: "memory");
}

// The sign bit of x[h] flipped where bit h of m is set: the same bits as a
// product with -1.0f.
template <int A>
__device__ __forceinline__ void flip_signs(float (&x)[A], unsigned m) {
#pragma unroll
  for (int h = 0; h < A; ++h) {
    const unsigned neg = ((m >> h) & 1u) << 31;
    x[h] = __uint_as_float(__float_as_uint(x[h]) ^ neg);
  }
}

// The forward gates of layer l, g8[l, j] on wire j = 0..W-1 (index bits
// W-1 .. 0: each register bit, then the lane and warp bits); (na, nb) hold
// gate (l, 0)'s scalars on entry and the next gate's on exit, so each
// gate's scalars are loaded one gate ahead. The layer is unrolled at every
// width: without the cotangent and dg its code is small enough that
// unrolling pays at 8-10 wires too, where the walk's loop over one body is
// faster.
template <int W>
__device__ __forceinline__ void fwd_layer(float (&sr)[WalkShape<W>::A],
                                          float (&si)[WalkShape<W>::A],
                                          const float* g, int l, int nd,
                                          float4& na, float4& nb, int r,
                                          int slot, float* xbuf, int& xpar) {
  constexpr int XB = WalkShape<W>::LB + WalkShape<W>::WB;
  // gate (l, j), and the scalars of the gate after it
  auto next = [&](int j, float4& ma, float4& mb) {
    ma = na;
    mb = nb;
    const int n = l * W + j + 1;
    if (n * 8 < nd) {
      na = *reinterpret_cast<const float4*>(g + n * 8);
      nb = *reinterpret_cast<const float4*>(g + n * 8 + 4);
    }
  };
#pragma unroll
  for (int bit = W - 1; bit >= XB; --bit) {
    float4 ma, mb;
    next(W - 1 - bit, ma, mb);
    fwd_gate<W, true>(sr, si, ma, mb, bit, r, slot, xbuf, xpar);
  }
#pragma unroll
  for (int bit = XB - 1; bit >= 0; --bit) {
    float4 ma, mb;
    next(W - 1 - bit, ma, mb);
    fwd_gate<W, false>(sr, si, ma, mb, bit, r, slot, xbuf, xpar);
  }
}

// The forward chain of one CTA's samples, from |0...0>: for each layer l,
// at l % k == 0 the encode (RZ, RY false: ea, eb are the phase planes pr,
// pi (d, B); RY: ea is cs (2w, B), eb unused), then the gate g8[l, j] on
// each wire j = 0..w-1 (index bits w-1 .. 0), then the CZ signs of plane
// l % k. out_r, out_i receive the (d, B) state planes. A sample's threads
// sync only among themselves, and only for a warp bit's exchange.
template <int W, bool RY>
__device__ __forceinline__ void chain_fwd(const float* __restrict__ ea,
                                          const float* __restrict__ eb,
                                          const float* __restrict__ g8,
                                          const float* __restrict__ signs,
                                          float* __restrict__ out_r,
                                          float* __restrict__ out_i,
                                          int batch, int n_layers, int k) {
  using Sh = WalkShape<W>;
  constexpr int D = Sh::D, A = Sh::A, T = Sh::T;
  constexpr int XB = Sh::LB + Sh::WB;  // the bits below the register bits
  extern __shared__ __align__(16) float smem[];
  const int samples = blockDim.x / T;
  const int slot = threadIdx.x / T;  // the sample's slot in the CTA
  const int r = threadIdx.x % T;     // the thread's rank in the sample
  const int b0 = blockIdx.x * samples;
  const int b = b0 + slot;
  const bool live = b < batch;
  const bool holds = live && r < D;  // below 5 wires lanes d..31 hold none
  const FwdLayout lay = fwd_layout(W, n_layers, k, samples, RY);
  const int nd = n_layers * W * 8;
  const float* g = smem;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  const float* enc = smem + lay.enc + static_cast<size_t>(slot) * 2 * W;
  float* xbuf = smem + lay.xbuf + static_cast<size_t>(slot) * 4 * D;

  // the read-only tables, once a CTA: the gate scalars by cp.async (every
  // copy in flight while the masks are built), and for each rank and sign
  // plane the bit mask of the rank's rows whose sign is -1
  const bool aligned = stage_gates(smem, g8, nd);
  for (int i = threadIdx.x; i < k * T; i += blockDim.x) {
    const int plane = i / T, rank = i % T;
    unsigned m = 0;
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const int row = walk_index<W>(h, rank);
      if (row < D && signs[static_cast<size_t>(plane) * D + row] < 0.0f)
        m |= 1u << h;
    }
    masks[i] = m;
  }
  if constexpr (RY) {
    for (int i = threadIdx.x; i < samples * 2 * W; i += blockDim.x) {
      const int bb = b0 + i / (2 * W);
      smem[lay.enc + i] =
          bb < batch ? ea[static_cast<size_t>(i % (2 * W)) * batch + bb]
                     : 0.0f;
    }
  }
  // RZ: the sample's phase column, in registers for the whole chain
  float phr[A], phi[A];
  if constexpr (!RY) {
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
      phr[h] = holds ? ea[at] : 0.0f;
      phi[h] = holds ? eb[at] : 0.0f;
    }
  }
  stage_wait(aligned);
  __syncthreads();  // the tables are in place; no block barrier follows
  if (!live) return;  // a sample's threads leave together

  float sr[A], si[A];  // |0...0>: row 0 is amplitude 0 of rank 0
#pragma unroll
  for (int h = 0; h < A; ++h) {
    sr[h] = (h == 0 && r == 0) ? 1.0f : 0.0f;
    si[h] = 0.0f;
  }
  int xpar = 0;
  // the next gate's scalars, loaded one gate ahead
  float4 na = *reinterpret_cast<const float4*>(g);
  float4 nb = *reinterpret_cast<const float4*>(g + 4);
  for (int l = 0; l < n_layers; ++l) {
    const unsigned flip = masks[(l % k) * T + r];
    if (l % k == 0) {
      if constexpr (RY) {
        // wire j = W-1-bit, from wire 0: each register bit, then the lane
        // and warp bits
#pragma unroll
        for (int bit = W - 1; bit >= XB; --bit)
          fwd_encode<W, true>(sr, si, enc[W - 1 - bit], enc[2 * W - 1 - bit],
                              bit, r, slot, xbuf, xpar);
#pragma unroll
        for (int bit = XB - 1; bit >= 0; --bit)
          fwd_encode<W, false>(sr, si, enc[W - 1 - bit],
                               enc[2 * W - 1 - bit], bit, r, slot, xbuf,
                               xpar);
      } else {
#pragma unroll
        for (int h = 0; h < A; ++h) {
          const float a = sr[h], c = si[h];
          sr[h] = a * phr[h] - c * phi[h];
          si[h] = a * phi[h] + c * phr[h];
        }
      }
    }
    fwd_layer<W>(sr, si, g, l, nd, na, nb, r, slot, xbuf, xpar);
    // the CZ signs: a sign flip where the mask says -1
    flip_signs(sr, flip);
    flip_signs(si, flip);
  }
  if (holds) {
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
      out_r[at] = sr[h];
      out_i[at] = si[h];
    }
  }
}

// Whether (samples, grid) is a plan the forward takes at `wires` (up to
// max_wires: 10 for the gate chains, 12 for the SEL chain) for `batch`
// samples: 1..MAX_SAMPLES samples a CTA and just enough CTAs.
inline bool fwd_plan_ok(int wires, int batch, int samples, int grid,
                        int max_wires = 10) {
  return wires >= 1 && wires <= max_wires && batch >= 1 && samples >= 1 &&
         samples <= walk_max_samples(wires) &&
         grid == (batch + samples - 1) / samples;
}

// Launches `kernel` (a forward instance) on `grid` CTAs of `samples`
// samples of `threads` threads each: a plain launch, no cluster.
template <typename... Params, typename... Args>
cudaError_t launch_fwd(void (*kernel)(Params...), int threads, int samples,
                       int grid, size_t smem, cudaStream_t stream,
                       Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, samples * threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launches `kernel` (a walk instance) on the plan's grid: `samples` samples
// a CTA of `threads` threads each, clusters of `cluster` CTAs, `clusters`
// of them.
template <typename... Params, typename... Args>
cudaError_t launch_walk(void (*kernel)(Params...), int threads, int samples,
                        int cluster, int clusters, size_t smem,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(samples * threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Whether (samples, cluster, clusters) is a plan the walk takes at `wires`
// (up to max_wires, as for fwd_plan_ok) for `batch` samples: 1..MAX_SAMPLES
// samples a CTA, a power of two up to 8 CTAs a cluster, and just enough
// clusters.
inline bool walk_plan_ok(int wires, int batch, int samples, int cluster,
                         int clusters, int max_wires = 10) {
  const int max_samples = walk_max_samples(wires);
  const long per_cluster = static_cast<long>(samples) * cluster;
  return wires >= 1 && wires <= max_wires && batch >= 1 && samples >= 1 &&
         samples <= max_samples && cluster >= 1 &&
         cluster <= kWalkMaxCluster && (cluster & (cluster - 1)) == 0 &&
         clusters == (batch + per_cluster - 1) / per_cluster;
}


// ------------------------------------------------------------- SEL chain

// Offsets, in floats, of a SEL CTA's shared-memory regions (the gate
// scalars at 0), each a multiple of 4 floats: the (p, w) int32 ring columns
// (p = max(w-1, 1); read for a CNOT ring), for the walk each sample's strip
// (STRIP_ROWS rows) and its dg (depth x w x 8), then each sample's two sets
// of exchange planes (2 x NP x d floats, NP = 2 forward, 4 backward), there
// for a warp bit's gates or a CNOT ring.
struct SelLayout {
  size_t cols, strip, dgs, xbuf, floats;
};

__host__ __device__ inline SelLayout sel_layout(int wires, int depth,
                                                int samples, bool bwd,
                                                bool cz) {
  const size_t d = static_cast<size_t>(1) << wires;
  const int warps = walk_warps(wires);
  const size_t rows = wires >= 11 ? warps : 32 * warps;  // STRIP_ROWS
  const size_t stride = static_cast<size_t>(8 * wires) + 4;
  const size_t nd = static_cast<size_t>(depth) * wires * 8;
  const size_t p = wires > 1 ? wires - 1 : 1;
  SelLayout o;
  o.cols = walk_round4(nd);
  o.strip = o.cols + walk_round4(p * wires);
  o.dgs = o.strip + (bwd ? walk_round4(samples * rows * stride) : 0);
  o.xbuf = o.dgs + (bwd ? walk_round4(samples * nd) : 0);
  o.floats = o.xbuf + (warps > 1 || (!cz && wires > 1)
                           ? samples * (bwd ? 8 : 4) * d
                           : 0);
  return o;
}

// The CZ ring of range rr (1..W-1), CZ(j, (j + rr) % W) on every wire j,
// at this thread's rows as a mask: bit h set where the sign of row
// i = walk_index(h, r) is -1, that is where popc(i & rotl_W(i, rr)) is
// odd (wire 0 the top bit). Computed from the index: no table.
template <int W>
__device__ __forceinline__ unsigned cz_mask(int r, int rr) {
  constexpr unsigned M = WalkShape<W>::D - 1;
  unsigned m = 0;
#pragma unroll
  for (int h = 0; h < WalkShape<W>::A; ++h) {
    const unsigned i = static_cast<unsigned>(walk_index<W>(h, r)) & M;
    const unsigned rot = ((i << rr) | (i >> (W - rr))) & M;
    m |= (__popc(i & rot) & 1u) << h;
  }
  return m;
}

// A CNOT ring on NP planes, in place, through the sample's exchange planes
// (the set xpar, as plane_exchange uses them, so one barrier): each thread
// writes its A values v(p, h) at their rows, passes the sample's barrier,
// and sets row i to the value at row map(i), map linear over GF(2): the XOR
// of the columns c[b] = map(1 << b) over i's set bits, the rank's bits once
// and each register bit's per amplitude. The forward's map is the gather
// inv (new[i] = old[inv(i)]); the walk's is the forward map f, which undoes
// it on the state and on the cotangent alike.
template <int W, int NP, typename Value, typename Set>
__device__ __forceinline__ void ring_gather(Value v, Set set, const int* c,
                                            int r, int slot, float* xbuf,
                                            int& xpar) {
  using Sh = WalkShape<W>;
  constexpr int XB = Sh::LB + Sh::WB;
  const bool in = Sh::D >= Sh::T || r < Sh::D;  // lanes d..31 hold none
  float* xb = xbuf + xpar * NP * Sh::D;
  xpar ^= 1;  // the next exchange writes the other set
  if (in) {
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      const int i = walk_index<W>(h, r);
#pragma unroll
      for (int p = 0; p < NP; ++p) xb[p * Sh::D + i] = v(p, h);
    }
  }
  int base = 0;  // map(r)
#pragma unroll
  for (int bit = 0; bit < XB; ++bit)
    if ((r >> bit) & 1) base ^= c[bit];
  walk_sync<W>(slot);
  if (in) {
#pragma unroll
    for (int h = 0; h < Sh::A; ++h) {
      int src = base;
#pragma unroll
      for (int kk = 0; kk < W - XB; ++kk)
        if ((h >> kk) & 1) src ^= c[XB + kk];
#pragma unroll
      for (int p = 0; p < NP; ++p) set(p, h, xb[p * Sh::D + src]);
    }
  }
}

// The SEL chain's forward (kernel #5) on one CTA's samples: from each
// sample's start column (sr0, si0)[:, b], for l = 0..depth-1 the gate
// g8[l, j] on each wire j = 0..W-1 (fwd_layer), then the ring of range
// l % (W-1) + 1 (none at W = 1): CZ a sign flip (cz_mask), CNOT a gather
// through the exchange planes (ring_gather; cols its (p, W) columns of
// inv). out_r, out_i receive the (d, B) planes. After the tables are
// staged a sample's threads sync only among themselves: for a warp bit's
// gate or a CNOT ring.
template <int W>
__device__ __forceinline__ void sel_fwd(const float* __restrict__ sr0,
                                        const float* __restrict__ si0,
                                        const float* __restrict__ g8,
                                        const int* __restrict__ cols,
                                        float* __restrict__ out_r,
                                        float* __restrict__ out_i, int batch,
                                        int depth, int is_cz) {
  using Sh = WalkShape<W>;
  constexpr int D = Sh::D, A = Sh::A, T = Sh::T;
  constexpr int P = W > 1 ? W - 1 : 1;
  extern __shared__ __align__(16) float smem[];
  const int samples = blockDim.x / T;
  const int slot = threadIdx.x / T;  // the sample's slot in the CTA
  const int r = threadIdx.x % T;     // the thread's rank in the sample
  const int b = blockIdx.x * samples + slot;
  const bool live = b < batch;
  const bool holds = live && r < D;  // below 5 wires lanes d..31 hold none
  const SelLayout lay = sel_layout(W, depth, samples, false, is_cz);
  const int nd = depth * W * 8;
  const float* g = smem;
  int* cs = reinterpret_cast<int*>(smem + lay.cols);
  float* xbuf = smem + lay.xbuf + static_cast<size_t>(slot) * 4 * D;

  // the tables, once a CTA: the gate scalars by cp.async, every copy in
  // flight while the ring columns and the sample's column load
  const bool aligned = stage_gates(smem, g8, nd);
  if (!is_cz)
    for (int i = threadIdx.x; i < P * W; i += blockDim.x) cs[i] = cols[i];
  float sr[A], si[A];  // the sample's column, in registers for the chain
#pragma unroll
  for (int h = 0; h < A; ++h) {
    const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
    sr[h] = holds ? sr0[at] : 0.0f;
    si[h] = holds ? si0[at] : 0.0f;
  }
  stage_wait(aligned);
  __syncthreads();  // the tables are in place; no block barrier follows
  if (!live) return;  // a sample's threads leave together

  int xpar = 0;
  // the next gate's scalars, loaded one gate ahead
  float4 na = *reinterpret_cast<const float4*>(g);
  float4 nb = *reinterpret_cast<const float4*>(g + 4);
#pragma unroll 1
  for (int l = 0; l < depth; ++l) {
    fwd_layer<W>(sr, si, g, l, nd, na, nb, r, slot, xbuf, xpar);
    if constexpr (W > 1) {
      const int q = l % (W - 1);
      if (is_cz) {
        const unsigned m = cz_mask<W>(r, q + 1);
        flip_signs(sr, m);
        flip_signs(si, m);
      } else {
        ring_gather<W, 2>(
            [&](int p, int h) { return p == 0 ? sr[h] : si[h]; },
            [&](int p, int h, float x) { (p == 0 ? sr[h] : si[h]) = x; },
            cs + q * W, r, slot, xbuf, xpar);
      }
    }
  }
  if (holds) {
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
      out_r[at] = sr[h];
      out_i[at] = si[h];
    }
  }
}

// The SEL chain's adjoint walk (kernel #6) on one CTA's samples: from the
// output (fr, fi) and its cotangent (gr, gi), for l = depth-1 .. 0 the
// inverse ring on both (CZ: the same signs; CNOT: ring_gather through the
// forward map f, cols its (p, W) columns), then walk_layer's adjoint gates
// with their dg partials, summed once a layer by walk_flush; (dsr, dsi)
// receive the cotangent at the start, dg_out dg summed over the cluster's
// samples (walk_batch_sum).
template <int W>
__device__ __forceinline__ void sel_walk(
    const float* __restrict__ g8, const int* __restrict__ cols,
    const float* __restrict__ fr, const float* __restrict__ fi,
    const float* __restrict__ gr, const float* __restrict__ gi,
    float* __restrict__ dg_out, float* __restrict__ dsr,
    float* __restrict__ dsi, int batch, int depth, int is_cz) {
  namespace cg = cooperative_groups;
  using Sh = WalkShape<W>;
  constexpr int D = Sh::D, A = Sh::A, T = Sh::T, NC = Sh::NC;
  constexpr int P = W > 1 ? W - 1 : 1;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int samples = blockDim.x / T;
  const int slot = threadIdx.x / T;  // the sample's slot in the CTA
  const int r = threadIdx.x % T;     // the thread's rank in the sample
  const int b0 = blockIdx.x * samples;
  const int b = b0 + slot;
  const bool live = b < batch;
  const bool holds = live && r < D;  // below 5 wires lanes d..31 hold none
  const SelLayout lay = sel_layout(W, depth, samples, true, is_cz);
  const int nd = depth * NC;
  const float* g = smem;
  int* cs = reinterpret_cast<int*>(smem + lay.cols);
  float* strip = smem + lay.strip +
                 static_cast<size_t>(slot) * Sh::STRIP_ROWS * Sh::STRIDE;
  float* dgs = smem + lay.dgs;
  float* mydg = dgs + static_cast<size_t>(slot) * nd;
  float* xbuf = smem + lay.xbuf + static_cast<size_t>(slot) * 8 * D;

  const bool aligned = stage_gates(smem, g8, nd);
  if (!is_cz)
    for (int i = threadIdx.x; i < P * W; i += blockDim.x) cs[i] = cols[i];
  // the sample's state and cotangent, in registers for the whole walk
  float sr[A], si[A], cr[A], ci[A];
#pragma unroll
  for (int h = 0; h < A; ++h) {
    const size_t at = static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
    sr[h] = holds ? fr[at] : 0.0f;
    si[h] = holds ? fi[at] : 0.0f;
    cr[h] = holds ? gr[at] : 0.0f;
    ci[h] = holds ? gi[at] : 0.0f;
  }
  stage_wait(aligned);
  __syncthreads();  // the tables are in place

  if (live) {
    int xpar = 0;
    // the next gate's scalars, loaded one gate ahead: (depth-1, W-1) first
    float4 na = *reinterpret_cast<const float4*>(g + (nd - 8));
    float4 nb = *reinterpret_cast<const float4*>(g + (nd - 4));
#pragma unroll 1
    for (int l = depth - 1; l >= 0; --l) {
      if constexpr (W > 1) {
        const int q = l % (W - 1);
        if (is_cz) {
          const unsigned m = cz_mask<W>(r, q + 1);
          flip_signs(sr, m);
          flip_signs(si, m);
          flip_signs(cr, m);
          flip_signs(ci, m);
        } else {
          ring_gather<W, 4>(
              [&](int p, int h) {
                return p == 0 ? sr[h] : p == 1 ? si[h] : p == 2 ? cr[h] : ci[h];
              },
              [&](int p, int h, float x) {
                (p == 0 ? sr[h] : p == 1 ? si[h] : p == 2 ? cr[h] : ci[h]) = x;
              },
              cs + q * W, r, slot, xbuf, xpar);
        }
      }
      walk_layer<W>(sr, si, cr, ci, g, l, na, nb, r, slot, xbuf, xpar,
                    strip);
      walk_flush<W>(strip, r, slot, mydg + l * NC);
    }
    if (holds) {
#pragma unroll
      for (int h = 0; h < A; ++h) {
        const size_t at =
            static_cast<size_t>(walk_index<W>(h, r)) * batch + b;
        dsr[at] = cr[h];
        dsi[at] = ci[h];
      }
    }
  }
  walk_batch_sum(cluster, dgs, nd, samples, batch, b0, dg_out);
}

}  // namespace
