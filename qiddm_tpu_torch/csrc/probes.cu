// Ceiling probes for NVIDIA Hopper (sm_90a): the six pallas_calls of the
// TPU's two probe tools, as kernels that measure this card's own ceilings.
//
// They replace, in tools/bench_pallas_wide_probe.py:
//   P1 probe_vmem (:40, call :48)      -> probe_smem_block_kernel,
//                                         probe_smem_cluster_kernel
//   P2 probe_transpose (:74, call :81) -> probe_transpose_kernel
//   P3 probe_reshape (:93, call :100)  -> probe_reshape_kernel
//   P5 probe_matmul2 (:112, call :124) -> probe_matmul2_kernel
//   P4 probe_dot3d (:138, call :149)   -> probe_dot3d_kernel
// and in tools/vpu_ceiling.py the FMA ceiling, _fma_kernel (:33, call :61)
//   -> fma_ceiling_kernel.
// qiddm_tpu_torch/tools/probe_kernels.py holds their wrappers and plain
// PyTorch versions; tools/vpu_ceiling.py and tools/wide_probe.py of the
// port drive them. None lies on a model's path.
//
// P1. How much on-chip memory one kernel holds. The TPU probe sizes a VMEM
// scratch; here the scratch is S bytes of dynamic shared memory, an
// (S / 512, 128) float32 array. The block writes x (8, 128) into its first
// and its last 8 rows and writes o = head + tail = 2x, one float4 of each a
// thread (256 threads). The TPU kernel reads a tail it never wrote, so its
// output is undefined; this one defines it. The launch is routed by shape:
// a cluster of one block needs no cluster, so C = 1 is a plain <<<>>>
// launch of probe_smem_block_kernel, a block barrier between the scratch's
// stores and the loads of o; C > 1 is a cluster launch of
// probe_smem_cluster_kernel (cudaLaunchKernelEx, cluster dimension C,
// C = 16 non-portable): each block fills its own scratch, and block 0 adds
// the tail of block C - 1's scratch, read through distributed shared
// memory (map_shared_rank). probe_smem_fits answers, for one (S, C), the
// capacity question: kCapacityRefused when the card refuses the shape (the
// attribute refused, or no block or cluster of that shape fits), and any
// other error as it is; it raises the kernel's shared-memory attribute to S
// (never lowers it), so the wrapper asks it once a shape and probe_smem
// only launches.
//
// P2. A transpose's cost. The TPU probe loops 50 x
// x <- transpose(transpose(x) * 1.000001) on a (128, 8192) plane in VMEM.
// No SM holds the 4 MiB plane, but the grid's shared memory does (132 x
// 227 KB), and a transpose never has to leave a block: the transpose of a
// column strip x[:, c0:c0+w] is the row strip x^T[c0:c0+w, :]. So block b
// owns the strip of columns w b .. w b + w - 1 (64 at the tools' shape: 128
// blocks, each 32 KB of strip and 32 KB of its transpose), reads it once,
// runs both transposes of all n_iters iterations in its own shared memory,
// and writes it once: a plain launch, no grid-wide barrier, no plane in
// device memory between the passes. Each pass is a real transpose: every
// element goes through shared memory into another thread's row (t[c][r] =
// s[r][c] * 1.000001f, one __fmul_rn an iteration, then s[r][c] = t[c][r]),
// a warp reading 32 consecutive floats and writing them down a column;
// each row is padded by one float, so no bank is hit twice. 1,024 threads
// a block; where each owns the same few elements (rows w = 1,024 E, E <=
// 8; E = 8 at the tools' shape) their offsets are worked out once and a
// pass is E loads, then E stores. The strip width comes from the shape
// (probe_kernels.transpose_plan). What bounds
// it: 2 n_iters transposes of 8 MB each (a read and a write of 4 MB)
// through shared memory at 128 bytes a clock an SM, about 27 us at the
// tools' shape; the plane's one read and one write from device memory are
// 2.5 us.
//
// P3. A relayout's cost. A row-major reshape of a contiguous plane is the
// identity on the flat index, so the relayout the TPU probe costs does not
// exist here. What remains, per element, n_iters times:
// v = (v * 1.000001f) * 0.999999f, written with __fmul_rn so that nvcc
// cannot fold the two constants: 2 n_iters dependent multiplies an element,
// each taking one lane-slot of the FMA pipes, so the card's floor is the
// multiplies over 128 lanes an SM a clock (3.1 us at (8192, 128) x 50).
// One wave (probe_kernels.reshape_plan): 4 blocks of 256 threads an SM,
// block b owning one contiguous run of float4s; a thread brings in its
// float4s (two at the tools' shape) with 16-byte loads before any
// arithmetic, then runs one float4's elements as independent chains
// interleaved (the multiplies' 4-clock latency hidden by the thread's own
// chains, not by more warps), stores it 16 bytes at a time and goes on to
// the next, so its first store drains under its second float4's
// multiplies; the loop over the iterations is unrolled by 4 (on an H100
// each of the two ran a little faster than all 8 elements interleaved at
// once and an unrolling by 2, in a side-by-side build). The n % 4 elements
// past the last float4 are the first threads' tail. Each element keeps its
// roundings in order, so the output is the plain version's bits.
//
// P5. The group product of a 20-wire state: n_iters x x <- g @ x, g (m, m),
// x (m, n), to float32 accuracy (the TPU's Precision.HIGHEST) as 3xTF32 on
// the tensor cores, wgmma (sm_90a). Each operand v is split into hi =
// tf32(v) and lo = tf32(v - hi) (round to nearest, ties away), and g x is
// summed as (g_hi x_hi) + (g_lo x_hi + g_hi x_lo); the dropped g_lo x_lo is
// below 2^-22 |g x|. The tensor cores round their sums toward zero, so the
// large term g_hi x_hi is chained over runs of kRun 8-deep k-steps in
// accumulators of its own, each run from zero, and the runs are added in
// float32 outside the product, then the small terms (chained over all of
// k); the run's length is set by the CPU emulation
// (tests/test_torch_probe_tf32.py) against P5's tolerance. Columns are
// independent: a block owns a strip of kCols = 64 columns (the plan of
// probe_kernels.matmul2_plan) across all rows and runs every product
// itself, reading its strip once and writing it once. Warpgroup r owns
// rows 64 r .. 64 r + 63 of g (one warpgroup for m <= 64, two to 128,
// rows and k zero-padded): its hi and lo halves stay in registers as
// wgmma's A fragments through all iterations. The strip is wgmma's B,
// K-major: [column][k], hi and lo planes, double-buffered in shared memory
// in the no-swizzle core-matrix layout (8 columns x 4 k, 128 contiguous
// bytes; a column group's k-chunks adjacent, so LBO = 128 B and SBO = 32 K
// B). Each iteration issues 3 K / 8 wgmma m64n64k8 a warpgroup in one commit
// group, waits, sums, and writes the product back transposed as the next
// buffer's hi and lo planes: four lanes of a quad trade their values by two
// shuffles each so that every lane stores a float4 along k, a warp on 512
// contiguous bytes, conflict-free; then fence.proxy.async (the async proxy
// sees the generic stores) and one block barrier. The last iteration
// stores to the output instead. Bound: 3 x 2 m^2 n n_iters TF32 flops at
// 495 TFLOP/s (81 us at the tools' shape); shared memory carries B three
// times a k-step (6 KB a warpgroup, below the tensor cores' time) and the
// epilogue's 2 m W floats a block an iteration. g's halves take 128
// registers a thread at m = 128 (254 in all, no spill). Three other
// layouts were built side by side on an H100 and dropped: a strip of 32
// columns a block (twice the blocks, m64n32k8; 7.5% slower), a product as
// two commit groups of 32 columns with the first half's epilogue under the
// second's products (no faster: m64n32k8 ran less efficiently than
// m64n64k8), and each warpgroup running its own half of k first behind
// named barriers (it spilled, and ran slower).
//
// P4. The contraction on x's middle axis: out[a, i, c] = sum_j g[i, j]
// x[a, j, c]. A block owns one slice a, all of g against its (m, w) slab
// (the plan of probe_kernels.dot3d_plan): a grid of a blocks, 128 blocks of
// 256 threads at the tools' (128, 128, 64). g and the slab are staged in
// chunks of KC k-rows, one cp.async group a chunk, each chunk's copies
// issued by every thread before the next chunk's (a barrier between): the
// block multiplies chunk c once it has landed while the later chunks are
// in flight, 2 chunks of 64 at m = 128. KC is a template argument, the
// largest of 64, 32, 16 and 8 that divides m, so a chunk's k loop unrolls
// in full. On the card (PERF.md, P4) the conflict-free staging and the
// unrolled chunk made the redesign's gain; the overlap of chunks gained
// nothing measurable, and splitting g's rows over more blocks only lost.
// The product, not the loads, sets the time: a 16-byte shared load is
// served a quarter-warp a cycle, so a warp's 12 of them per 4 k (8 of g, 4
// of the slab) take 48 cycles of the SM's one shared-memory pipe against
// its 128 FMAs on one of four FMA pipes; 8 warps an SM hold the FMAs to at
// most 2/3 of their rate. The TPU probe asked whether Mosaic lowers it;
// here it always runs.
//
// It sums each output over k in order from zero, one fmaf a term
// (probe_kernels.in_order_matmul emulates it exactly), so the output does
// not depend on the chunks or the tile.
//
// Shared memory: g chunk-major, [m / KC][m][KC] floats, and the
// slab row-major, [m][W]; each chunk of either is one
// dense run. A cp.async copies 16 bytes, thread t of the chunk's copies
// writing bytes 16 t .. 16 t + 15 of that run, so each quarter-warp (8
// lanes, the unit a 16-byte shared access is served in) writes 128
// consecutive bytes: every bank once, conflict-free for every m and W.
// Reads: the slab row of a k is 4 consecutive floats a lane,
// conflict-free; a lane reads its 8 rows of g as float4 along k, and the
// lanes of a quarter-warp share their rows when W >= 32 (a broadcast, as
// at the tools' shapes); at narrower W a quarter-warp spans 8 / (W / 4)
// row tiles that lie 8 KC floats apart, on the same banks: that many ways.
//
// FMA ceiling. One thread an element of the (d, B) planes, `chains`
// independent accumulators in registers (a template over 1, 4, 8),
// a_c = x * (1 + 0.1 c), then iters x a_c = fmaf(a_c, 1.0000001f, y) with a
// runtime trip count, output the left fold a_0 + a_1 + ... (the TPU body's
// order). chains = 1 is one dependent chain (latency-bound); more chains
// give the scheduler independent FMAs (the throughput ceiling).
//
// Plain C interface (bound with ctypes): each entry launches on the
// caller's stream, allocates nothing, does not synchronise, and returns a
// cudaError_t (or kCapacityRefused from probe_smem_fits).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wide_common.cuh"  // cp_async_n, cp_async_commit, cp_async_wait,
                            // tf32_bits

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;                // P1 scratch row, floats
constexpr int kHeadRows = 8;               // x is (8, 128)
constexpr int kHead = kHeadRows * kLanes;  // floats of x
constexpr int kRowBytes = kLanes * 4;
constexpr int kSmemThreads = kHead / 4;  // one float4 of x a thread
constexpr int kCapacityRefused = -1;

constexpr int kT = 32;  // P2: a strip's width and the plane's rows are
                        // multiples of a warp
constexpr int kTThreads = 1024;  // P2's block: 32 warps hide the passes'
                                 // load-to-store latency

constexpr int kRM = 8;  // P4 register tile: rows x columns a thread
constexpr int kRC = 4;
constexpr int kMaxChunks = 8;  // P4: chunks whose groups are waited for
                               // one at a time

constexpr int kThreads = 256;

constexpr int kReshapeVec = 2;  // P3: float4s a thread a round

constexpr int kWarpgroup = 128;  // P5: threads of a warpgroup
constexpr int kRowTile = 64;     // P5: wgmma's M; rows a warpgroup
constexpr int kCols = 64;        // P5: wgmma's N; a block's strip
constexpr int kMaxRowTiles = 2;  // P5: m <= 128
constexpr int kRun = 8;  // P5: 8-deep k-steps the large term chains in one
                         // accumulator (tests/test_torch_probe_tf32.py)

// ---------------------------------------------------------------- P1

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Thread i writes float4 i of x into the head and the tail of the scratch;
// the tail starts `tail` float4 in.
__global__ void __launch_bounds__(kSmemThreads)
    probe_smem_block_kernel(const float4* __restrict__ x,
                            float4* __restrict__ o, int tail) {
  extern __shared__ float4 scratch[];
  const int i = threadIdx.x;
  const float4 v = x[i];
  scratch[i] = v;
  scratch[tail + i] = v;
  __syncthreads();
  o[i] = add4(scratch[i], scratch[tail + i]);
}

__global__ void __launch_bounds__(kSmemThreads)
    probe_smem_cluster_kernel(const float4* __restrict__ x,
                              float4* __restrict__ o, int tail) {
  extern __shared__ float4 scratch[];
  cg::cluster_group cluster = cg::this_cluster();
  const int i = threadIdx.x;
  const float4 v = x[i];
  scratch[i] = v;
  scratch[tail + i] = v;
  cluster.sync();  // every block of the cluster has filled its scratch
  if (cluster.block_rank() == 0) {
    const float4* remote =
        cluster.map_shared_rank(scratch, cluster.num_blocks() - 1);
    o[i] = add4(scratch[i], remote[tail + i]);
  }
  cluster.sync();  // the last block stays resident until block 0 has read
}

// ---------------------------------------------------------------- P2

// Shared memory of P2's block: the strip [rows][w + 1] and its transpose
// [w][rows + 1], float32.
size_t transpose_smem(int rows, int w) {
  return (static_cast<size_t>(rows) * (w + 1) +
          static_cast<size_t>(w) * (rows + 1)) *
         sizeof(float);
}

// One pass: dst[i][o] = src[o][i] (times 1.000001f when kScale) for the
// n_out rows o and n_in columns i of src. Warp y takes rows y, y + 32, ..,
// lane x columns x, x + 32, ..: a warp reads 32 consecutive floats of a
// row of src and writes them down a column of dst. With row strides ld_src
// and ld_dst of 1 mod 32 (a float of padding on a multiple of 32), both
// sides hit 32 banks: x + o and x + i. A thread's NO x NI loads (all of
// its pass at the tools' shape) are issued before its stores, so each warp
// keeps them in flight.
template <int NO, int NI, bool kScale>
__device__ __forceinline__ void strip_pass(const float* src, float* dst,
                                           int n_out, int n_in, int ld_src,
                                           int ld_dst) {
  constexpr int kWarps = kTThreads / kT;
  const int x = threadIdx.x & (kT - 1);
  const int y = threadIdx.x / kT;
  for (int o0 = y; o0 < n_out; o0 += kWarps * NO)
    for (int i0 = x; i0 < n_in; i0 += kT * NI) {
      float v[NO][NI];
#pragma unroll
      for (int m = 0; m < NO; ++m)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int o = o0 + kWarps * m;
          const int i = i0 + kT * j;
          v[m][j] = o < n_out && i < n_in ? src[o * ld_src + i] : 0.0f;
        }
#pragma unroll
      for (int m = 0; m < NO; ++m)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int o = o0 + kWarps * m;
          const int i = i0 + kT * j;
          if (o < n_out && i < n_in)
            dst[i * ld_dst + o] =
                kScale ? __fmul_rn(v[m][j], 1.000001f) : v[m][j];
        }
    }
}

// The passes when each thread owns exactly E elements of the strip (rows w
// = 1024 E, E <= 8; the tools' shape: E = 8): element f = 1024 e + tid is
// (f / w, f % w) of s in the first pass and (f / rows, f % rows) of t in
// the second, a warp on 32 consecutive floats of a row either way, so the
// banks are those of strip_pass. The 4 E offsets are worked out once, so
// a pass is E loads, then E stores (and E multiplies), nothing else.
template <int E>
__device__ __forceinline__ void owned_passes(float* s, float* t, int rows,
                                             int w, int n_iters) {
  const int ls = w + 1;
  const int lt = rows + 1;
  int s_rd[E], t_wr[E], t_rd[E], s_wr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int f = e * kTThreads + static_cast<int>(threadIdx.x);
    s_rd[e] = (f / w) * ls + f % w;
    t_wr[e] = (f % w) * lt + f / w;
    t_rd[e] = (f / rows) * lt + f % rows;
    s_wr[e] = (f % rows) * ls + f / rows;
  }
  for (int it = 0; it < n_iters; ++it) {
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[s_rd[e]];
#pragma unroll
    for (int e = 0; e < E; ++e) t[t_wr[e]] = __fmul_rn(v[e], 1.000001f);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = t[t_rd[e]];
#pragma unroll
    for (int e = 0; e < E; ++e) s[s_wr[e]] = v[e];
    __syncthreads();
  }
}

// Block b: columns w b .. w b + w - 1 of x (rows, cols) through n_iters
// iterations of t = s^T * 1.000001f, s = t^T, into the same columns of o;
// E > 0: each thread owns E elements (owned_passes), else strip_pass.
template <int E>
__global__ void __launch_bounds__(kTThreads)
    probe_transpose_kernel(const float* __restrict__ x,
                           float* __restrict__ o, int rows, int cols, int w,
                           int n_iters) {
  extern __shared__ float strip[];
  const int ls = w + 1;
  const int lt = rows + 1;
  float* s = strip;          // [rows][w + 1]
  float* t = s + rows * ls;  // [w][rows + 1]
  const int tx = threadIdx.x & (kT - 1);
  const int ty = threadIdx.x / kT;
  constexpr int kWarps = kTThreads / kT;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * w;
  for (int r = ty; r < rows; r += kWarps)
    for (int c = tx; c < w; c += kT)
      s[r * ls + c] = x[static_cast<size_t>(r) * cols + c0 + c];
  __syncthreads();
  if constexpr (E > 0) {
    owned_passes<E>(s, t, rows, w, n_iters);
  } else {
    for (int it = 0; it < n_iters; ++it) {
      strip_pass<4, 2, true>(s, t, rows, w, ls, lt);   // t = s^T * 1.000001
      __syncthreads();
      strip_pass<2, 4, false>(t, s, w, rows, lt, ls);  // s = t^T
      __syncthreads();
    }
  }
  for (int r = ty; r < rows; r += kWarps)
    for (int c = tx; c < w; c += kT)
      o[static_cast<size_t>(r) * cols + c0 + c] = s[r * ls + c];
}

// ---------------------------------------------------------------- P3

// Block b owns float4s b per .. b per + per - 1 (per = ceil(n4 / blocks));
// a thread takes kReshapeVec of them a round, kThreads apart, and loads
// them all before any arithmetic; then, one float4 after the other, it runs
// its 4 elements as independent chains interleaved and stores it, so the
// first float4's multiplies start while the second's load is in flight and
// its store drains under the second's multiplies. Threads 0 .. n % 4 - 1
// of block 0 also take the tail.
__global__ void __launch_bounds__(kThreads)
    probe_reshape_kernel(const float* __restrict__ x, float* __restrict__ o,
                         long long n, int n_iters) {
  const long long n4 = n / 4;
  const long long per = (n4 + gridDim.x - 1) / gridDim.x;
  const long long begin = blockIdx.x * per;
  const long long end = begin + per < n4 ? begin + per : n4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long long i0 = begin + threadIdx.x; i0 < end;
       i0 += kReshapeVec * kThreads) {
    float e[kReshapeVec][4];
#pragma unroll
    for (int j = 0; j < kReshapeVec; ++j) {
      const long long i = i0 + j * kThreads;
      const float4 v = i < end ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      e[j][0] = v.x;
      e[j][1] = v.y;
      e[j][2] = v.z;
      e[j][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kReshapeVec; ++j) {
#pragma unroll 4
      for (int it = 0; it < n_iters; ++it) {
#pragma unroll
        for (int q = 0; q < 4; ++q) e[j][q] = __fmul_rn(e[j][q], 1.000001f);
#pragma unroll
        for (int q = 0; q < 4; ++q) e[j][q] = __fmul_rn(e[j][q], 0.999999f);
      }
      const long long i = i0 + j * kThreads;
      if (i < end) o4[i] = make_float4(e[j][0], e[j][1], e[j][2], e[j][3]);
    }
  }
  const long long tail = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    float v = x[tail];
    for (int it = 0; it < n_iters; ++it)
      v = __fmul_rn(__fmul_rn(v, 1.000001f), 0.999999f);
    o[tail] = v;
  }
}

// ---------------------------------------------------------------- P4

// Shared memory of a P4 block: g and its (m, w) slab.
size_t slab_smem(int m, int w) {
  return (static_cast<size_t>(m) + w) * m * sizeof(float);
}

// k-rows a chunk: the largest of 64, 32, 16 and 8 that divides m (m is a
// multiple of 8).
int chunk_rows(int m) {
  for (int kc = 64; kc > 8; kc /= 2)
    if (m % kc == 0) return kc;
  return 8;
}

// Issues this thread's cp.async copies of chunk c: k-rows c KC .. c KC +
// KC - 1 of g (m, m) into gs, and of the (m, W) source (row stride ld)
// into the slab. Each chunk of gs and of the slab is dense, and copy p
// writes its 16 bytes at 16 p: see the header for why that is
// conflict-free. m, W, ld and KC are multiples of 4 and the pointers
// 16-byte aligned.
template <int KC>
__device__ __forceinline__ void stage_chunk(float* gs, float* slab,
                                            const float* __restrict__ g,
                                            const float* __restrict__ src,
                                            int m, int w, long long ld,
                                            int c) {
  constexpr int q = KC / 4;  // copies a row of a g chunk
  float* gc = gs + c * m * KC;
  for (int p = threadIdx.x; p < m * q; p += blockDim.x) {
    const int r = p / q;
    cp_async_n<16>(gc + 4 * p, g + r * m + c * KC + 4 * (p - r * q));
  }
  const int wq = w / 4;
  float* sc = slab + c * KC * w;
  for (int p = threadIdx.x; p < KC * wq; p += blockDim.x) {
    const int k = p / wq;
    cp_async_n<16>(sc + 4 * p, src + (c * KC + k) * ld + 4 * (p - k * wq));
  }
}

// acc += (g @ slab) on this thread's rows r0 .. r0 + 7 and
// columns c0 .. c0 + 3, over the k-rows of chunk c, in order, one fmaf
// a term.
template <int KC>
__device__ __forceinline__ void chunk_product(const float* gs,
                                              const float* slab, int m,
                                              int w, int r0, int c0, int c,
                                              float (&acc)[kRM][kRC]) {
  const float* gc = gs + (c * m + r0) * KC;
  const float* sc = slab + c * KC * w + c0;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 4) {
    float4 a[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      a[i] = *reinterpret_cast<const float4*>(gc + i * KC + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sc + (kk + j) * w);
      const float bb[kRC] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float ak = j == 0 ? a[i].x : j == 1 ? a[i].y
                       : j == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int jj = 0; jj < kRC; ++jj)
          acc[i][jj] = fmaf(ak, bb[jj], acc[i][jj]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRM][kRC]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = 0.0f;
}

// Waits until at most n of this thread's newest copy groups are in
// flight; n above kMaxChunks - 1 waits for more than it must.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < kMaxChunks - 1 ? n : kMaxChunks - 1) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Block b: out[b] = g @ x[b], each x[a] an (m, w) plane.
template <int KC>
__global__ void __launch_bounds__(kThreads)
    probe_dot3d_kernel(const float* __restrict__ g,
                       const float* __restrict__ x, float* __restrict__ o,
                       int m, int w) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);
  float* slab = gs + m * m;
  const long long off = static_cast<long long>(blockIdx.x) * m * w;
  const int chunks = m / KC;
  for (int c = 0; c < chunks; ++c) {
    stage_chunk<KC>(gs, slab, g, x + off, m, w, w, c);
    cp_async_commit();
    if (c + 1 < chunks) __syncthreads();  // chunk c goes out first
  }
  const int r0 = kRM * (threadIdx.x / (w / kRC));
  const int c0 = kRC * (threadIdx.x % (w / kRC));
  float acc[kRM][kRC];
  zero(acc);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_upto(chunks - 1 - c);  // chunk c has landed
    __syncthreads();                     // for every thread's copies
    chunk_product<KC>(gs, slab, m, w, r0, c0, c, acc);
  }
  float* out = o + off + static_cast<long long>(r0) * w + c0;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
    *reinterpret_cast<float4*>(out + i * w) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------- P5

// Shared memory of a P5 block: two buffers of the strip's hi and lo planes,
// kCols columns x K = 64 row_tiles k each, float32.
size_t matmul2_smem(int row_tiles) {
  return static_cast<size_t>(2) * 2 * kCols * kRowTile * row_tiles *
         sizeof(float);
}

// v's TF32 halves as bit patterns: hi = tf32(v), lo = tf32(v - hi), each
// rounded to nearest, ties away from zero, low 13 bits clear.
__device__ __forceinline__ void split_tf32_rn(float v, unsigned* hi,
                                              unsigned* lo) {
  *hi = tf32_bits(v);
  *lo = tf32_bits(v - __uint_as_float(*hi));
}

// The hi halves of a, b, c, d; their lo halves into *lo.
__device__ __forceinline__ float4 hi_lo4(float a, float b, float c, float d,
                                         float4* lo) {
  unsigned h[4], l[4];
  split_tf32_rn(a, &h[0], &l[0]);
  split_tf32_rn(b, &h[1], &l[1]);
  split_tf32_rn(c, &h[2], &l[2]);
  split_tf32_rn(d, &h[3], &l[3]);
  *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// The wgmma descriptor of a K-major operand in shared memory, no swizzle:
// 8-row x 16-byte core matrices of 128 contiguous bytes, `lbo` bytes
// between the two k-chunks of an 8-deep step, `sbo` bytes between 8-row
// groups.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int lbo,
                                               int sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The async proxy (wgmma's operand reads) sees this thread's generic
// shared-memory stores from here on, once a barrier has passed.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b on a 64 x 64 x 8 TF32 step: a the warpgroup's A fragment in
// registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of
// the warp's 16 rows, g = lane / 4, t = lane % 4), b a descriptor of the
// K-major B; scale_d 0 starts d from zero. d: per 8-column block c,
// d[4c] (g, 8c + 2t), d[4c + 1] (g, 8c + 2t + 1), d[4c + 2] (g + 8, 8c +
// 2t), d[4c + 3] (g + 8, 8c + 2t + 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Lanes 4 apart (g, g ^ 1, g ^ 2, g ^ 3 at one t) hold v[j] of rows g and
// g + 8 (j >> 1), columns 2t + (j & 1); after two butterfly exchanges the
// lane with i = g % 4 holds, in v[0..3], rows 4 (g / 4) + 8 (i >> 1) +
// 0..3 of column 2t + (i & 1): a 4 x 4 transpose across the quad.
__device__ __forceinline__ void quad_transpose(float (&v)[4], int i) {
  const unsigned all = 0xffffffffu;
  const bool odd = i & 1;
  float r0 = __shfl_xor_sync(all, odd ? v[0] : v[1], 4);
  float r1 = __shfl_xor_sync(all, odd ? v[2] : v[3], 4);
  if (odd) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
  const bool high = i & 2;
  r0 = __shfl_xor_sync(all, high ? v[0] : v[2], 8);
  r1 = __shfl_xor_sync(all, high ? v[1] : v[3], 8);
  if (high) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

// Block b: columns W b .. W b + W - 1 of x (m, n), W = kCols, through
// n_iters products with g (m, m), into the same columns of o. MT
// warpgroups, warpgroup r the rows 64 r ..; K = 64 MT (rows and k past m
// are zero).
template <int MT>
__global__ void __launch_bounds__(MT * kWarpgroup, 1)
    probe_matmul2_kernel(const float* __restrict__ g,
                         const float* __restrict__ x, float* __restrict__ o,
                         int m, int n, int n_iters) {
  constexpr int W = kCols;
  constexpr int K = kRowTile * MT;
  constexpr int KS = K / 8;         // 8-deep k-steps
  constexpr int kRuns = KS / kRun;  // the large term's accumulators
  constexpr int R = W / 2;          // accumulator registers
  constexpr int kPlane = W * K;     // floats of a plane
  constexpr int kGroup = 8 * K;     // floats of 8 columns' k
  extern __shared__ float4 smem4[];
  float* strip = reinterpret_cast<float*>(smem4);  // [2][hi, lo][W/8][K]
  const int tid = threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * W;
  if (n_iters == 0) {
    for (int e = tid; e < m * W; e += MT * kWarpgroup) {
      const long long at = (e / W) * static_cast<long long>(n) + col0 + e % W;
      o[at] = x[at];
    }
    return;
  }
  // The strip into buffer 0: a thread a column and 4 rows, 16 bytes a
  // plane (each 8 columns' 4 k a 128-byte core matrix, k-chunks adjacent).
  for (int e = tid; e < W * (K / 4); e += MT * kWarpgroup) {
    const int c = e % W, kc = e / W;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * kc + r;
      v[r] = k < m ? x[k * static_cast<long long>(n) + col0 + c] : 0.0f;
    }
    const int at = (c / 8) * kGroup + kc * 32 + (c % 8) * 4;
    float4 lo;
    *reinterpret_cast<float4*>(strip + at) = hi_lo4(v[0], v[1], v[2], v[3],
                                                   &lo);
    *reinterpret_cast<float4*>(strip + kPlane + at) = lo;
  }
  // This warpgroup's rows of g, split, as A fragments for every k-step.
  const int wg = tid / kWarpgroup;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = kRowTile * wg + 16 * warp + gq;
  unsigned ahi[KS][4], alo[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + 8 * (j & 1);
      const int k = 8 * s + tq + 4 * (j >> 1);
      split_tf32_rn(row < m && k < m ? g[row * m + k] : 0.0f, &ahi[s][j],
                    &alo[s][j]);
    }
  fence_async_smem();
  __syncthreads();
  const int qi = gq & 3;
  // this lane's float4 along k after the quad transpose, within each
  // 8-column group: its k-chunk, then its column
  const int chunk = (kRowTile * wg + 16 * warp + 4 * (gq >> 2) +
                     8 * (qi >> 1)) / 4;
  const int store_at = chunk * 32 + (2 * tq + (qi & 1)) * 4;
  int buf = 0;
  for (int it = 0;; ++it) {
    const float* bh = strip + buf * 2 * kPlane;
    const uint64_t dh = wgmma_desc(bh, 128, 32 * K);
    const uint64_t dl = wgmma_desc(bh + kPlane, 128, 32 * K);
    float small[R], large[kRuns][R];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint64_t step = 16 * s;  // 256 bytes a k-step, in 16-byte units
      wgmma_tf32(small, alo[s], dh + step, s > 0);
      wgmma_tf32(small, ahi[s], dl + step, 1);
      wgmma_tf32(large[s / kRun], ahi[s], dh + step, s % kRun != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(small);
#pragma unroll
    for (int r = 0; r < kRuns; ++r) fence_regs(large[r]);
    // the runs in order, in float32, then the small terms
    float* d = large[0];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sum = large[0][i];
#pragma unroll
      for (int r = 1; r < kRuns; ++r) sum = sum + large[r][i];
      d[i] = sum + small[i];
    }
    if (it + 1 == n_iters) {
#pragma unroll
      for (int c = 0; c < W / 8; ++c) {
        const long long col = col0 + 8 * c + 2 * tq;
        if (row0 < m)
          *reinterpret_cast<float2*>(o + row0 * static_cast<long long>(n) +
                                     col) = make_float2(d[4 * c],
                                                        d[4 * c + 1]);
        if (row0 + 8 < m)
          *reinterpret_cast<float2*>(
              o + (row0 + 8) * static_cast<long long>(n) + col) =
              make_float2(d[4 * c + 2], d[4 * c + 3]);
      }
      return;
    }
    buf ^= 1;
    float* wh = strip + buf * 2 * kPlane;
#pragma unroll
    for (int c = 0; c < W / 8; ++c) {
      float v[4] = {d[4 * c], d[4 * c + 1], d[4 * c + 2], d[4 * c + 3]};
      quad_transpose(v, qi);
      float4 lo;
      const int at = c * kGroup + store_at;
      *reinterpret_cast<float4*>(wh + at) = hi_lo4(v[0], v[1], v[2], v[3],
                                                   &lo);
      *reinterpret_cast<float4*>(wh + kPlane + at) = lo;
    }
    fence_async_smem();
    __syncthreads();
  }
}

// ---------------------------------------------------------------- FMA

template <int C>
__global__ void __launch_bounds__(kThreads)
    fma_ceiling_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ o,
                       long long n, int iters) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const float xv = x[i], yv = y[i];
  float a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = xv * static_cast<float>(1.0 + 0.1 * c);
#pragma unroll 4
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = fmaf(a[c], 1.0000001f, yv);
  float out = a[0];
#pragma unroll
  for (int c = 1; c < C; ++c) out = out + a[c];
  o[i] = out;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Threads of a slab product's block, or 0 when (m, w) does not tile.
int slab_threads(int m, int w) {
  if (m < kRM || m % kRM != 0 || w < kRC || w % kRC != 0) return 0;
  const int threads = (m / kRM) * (w / kRC);
  return threads <= kThreads ? threads : 0;
}

// P1's kernel for a cluster of `cluster` blocks.
const void* smem_kernel(int cluster) {
  return cluster == 1 ? reinterpret_cast<const void*>(probe_smem_block_kernel)
                      : reinterpret_cast<const void*>(probe_smem_cluster_kernel);
}

// P1's launch configuration for a cluster of `cluster` blocks of
// smem_bytes; attr must outlive cfg.
cudaLaunchConfig_t smem_config(int smem_bytes, int cluster, void* stream,
                               cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kSmemThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool smem_shape_ok(int smem_bytes, int cluster) {
  return smem_bytes % kRowBytes == 0 &&
         smem_bytes >= 2 * kHeadRows * kRowBytes && cluster >= 1;
}

}  // namespace

extern "C" {

// P1's capacity answer for a scratch of smem_bytes (a multiple of 512, at
// least 16 rows) a block in a cluster of `cluster` blocks: cudaSuccess when
// the card holds it, kCapacityRefused when it does not, any other error as
// it is. Raises the kernel's dynamic shared-memory attribute to smem_bytes
// when it is below, never lowers it, so a shape that fitted still launches.
int probe_smem_fits(int smem_bytes, int cluster, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!smem_shape_ok(smem_bytes, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = smem_kernel(cluster);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fa.maxDynamicSharedSizeBytes < smem_bytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err == cudaErrorInvalidValue) {
      cudaGetLastError();
      return kCapacityRefused;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (cluster == 1) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_smem_block_kernel, kSmemThreads, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    return per_sm < 1 ? kCapacityRefused : cudaSuccess;
  }
  err = cudaFuncSetAttribute(probe_smem_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      smem_config(smem_bytes, cluster, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, probe_smem_cluster_kernel,
                                       &cfg);
  if (err == cudaErrorInvalidClusterSize || err == cudaErrorInvalidValue) {
    cudaGetLastError();
    return kCapacityRefused;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return clusters < 1 ? kCapacityRefused : cudaSuccess;
}

// P1: x and o are (8, 128) float32, 16-byte aligned; a shape
// probe_smem_fits has accepted. The launch is routed by shape: a plain
// launch at cluster 1 (the function needs no cluster there), a cluster
// launch above.
int probe_smem(const void* x, void* o, int smem_bytes, int cluster,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!smem_shape_ok(smem_bytes, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* xp = static_cast<const float4*>(x);
  float4* op = static_cast<float4*>(o);
  const int tail = (smem_bytes / kRowBytes - kHeadRows) * kLanes / 4;
  if (cluster == 1) {
    probe_smem_block_kernel<<<1, kSmemThreads, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(xp, op,
                                                                   tail);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      smem_config(smem_bytes, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, probe_smem_cluster_kernel, xp, op, tail);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// P2's shared memory a block at a strip of w columns.
size_t probe_transpose_smem_bytes(int rows, int w) {
  return transpose_smem(rows, w);
}

// P2: x and o are (rows, cols), rows and cols multiples of 32; a block a
// strip of w columns (a multiple of 32 that divides cols), n_iters >= 1.
// One plain launch.
int probe_transpose(const void* x, void* o, int rows, int cols, int w,
                    int n_iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < kT || rows % kT != 0 || w < kT || w % kT != 0 ||
      cols % w != 0 || n_iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = transpose_smem(rows, w);
  const int per = rows * w % kTThreads == 0 ? rows * w / kTThreads : 0;
  void (*kernel)(const float*, float*, int, int, int, int) =
      per == 8   ? probe_transpose_kernel<8>
      : per == 4 ? probe_transpose_kernel<4>
      : per == 2 ? probe_transpose_kernel<2>
      : per == 1 ? probe_transpose_kernel<1>
                 : probe_transpose_kernel<0>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cols / w, kTThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), rows, cols, w,
      n_iters);
  return static_cast<int>(cudaGetLastError());
}

// P3: x and o hold n float32, 16-byte aligned; `blocks` blocks (the plan
// of probe_kernels.reshape_plan), each a contiguous run of float4s.
int probe_reshape(const void* x, void* o, long long n, int n_iters,
                  int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n_iters < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_reshape_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// P5's shared memory a block at m rows (0 for a shape it does not take).
size_t probe_matmul2_smem_bytes(int m) {
  if (m < 1 || m > kRowTile * kMaxRowTiles) return 0;
  return matmul2_smem((m + kRowTile - 1) / kRowTile);
}

// P5: g (m, m), x and o (m, n), 16-byte aligned, under
// probe_kernels.matmul2_plan's plan (blocks, threads, smem_bytes): n / 64
// blocks of 128 ceil(m / 64) threads, a strip of 64 columns each. Any
// other plan is cudaErrorInvalidValue.
int probe_matmul2(const void* g, const void* x, void* o, int m, int n,
                  int blocks, int threads, int smem_bytes, int n_iters,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = probe_matmul2_smem_bytes(m);
  const int mt = (m + kRowTile - 1) / kRowTile;
  if (smem == 0 || n < kCols || n % kCols != 0 || blocks != n / kCols ||
      threads != mt * kWarpgroup ||
      static_cast<size_t>(smem_bytes) != smem || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, threads, smem, s>>>(gp, xp, op, m, n, n_iters);
    return cudaGetLastError();
  };
  return static_cast<int>(mt == 1 ? launch(probe_matmul2_kernel<1>)
                                  : launch(probe_matmul2_kernel<2>));
}

// P4: g (m, m), x and o (a, m, w), under probe_kernels.dot3d_plan's plan
// (grid, threads, smem_bytes): a blocks, one a slice, of slab_threads(m, w)
// threads and slab_smem(m, w) bytes. Any other plan is
// cudaErrorInvalidValue.
int probe_dot3d(const void* g, const void* x, void* o, int a, int m, int w,
                int grid, int threads, int smem_bytes, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = slab_smem(m, w);
  if (a < 1 || grid != a || slab_threads(m, w) == 0 ||
      threads != slab_threads(m, w) ||
      static_cast<size_t>(smem_bytes) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, s>>>(gp, xp, op, m, w);
    return cudaGetLastError();
  };
  switch (chunk_rows(m)) {
    case 64: return static_cast<int>(launch(probe_dot3d_kernel<64>));
    case 32: return static_cast<int>(launch(probe_dot3d_kernel<32>));
    case 16: return static_cast<int>(launch(probe_dot3d_kernel<16>));
    default: return static_cast<int>(launch(probe_dot3d_kernel<8>));
  }
}

// FMA ceiling: x, y and o hold n float32; chains is 1, 4 or 8.
int fma_ceiling(const void* x, const void* y, void* o, long long n, int iters,
                int chains, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* op = static_cast<float*>(o);
  switch (chains) {
    case 1:
      fma_ceiling_kernel<1><<<blocks, kThreads, 0, s>>>(xp, yp, op, n, iters);
      break;
    case 4:
      fma_ceiling_kernel<4><<<blocks, kThreads, 0, s>>>(xp, yp, op, n, iters);
      break;
    case 8:
      fma_ceiling_kernel<8><<<blocks, kThreads, 0, s>>>(xp, yp, op, n, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
