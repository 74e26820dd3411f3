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
// Forward design (wide_group_mma_kernel, NRHS = 1; group_mma in
// wide_common.cuh). One launch per group, of persistent blocks: the grid
// is the blocks the occupancy query lets the card hold at once (one or two
// an SM), at most one a column tile. Each block stages G into shared
// memory once (cp.async, in its first tile's copy group; 136 KB at
// D = 128, 36 KB at D = 64, zero-padded to 16 rows below D = 16; G^H is
// read from it transposed), then walks its own fixed set of column tiles
// (blockIdx.x, + gridDim.x, ...). A tile's D rows go through a two-stage
// cp.async ring, tile t+1 in flight while tile t is multiplied, 16, 8 or 4
// bytes a copy as the rows' alignment allows (runs of B floats in the last
// group, 40 bytes at B = 10, which TMA cannot describe). A tile is a
// segment of one p-row of the view or, where a p-row is shorter than a
// tile (the last group: post = 1), whole p-blocks, one contiguous run;
// each tile's column offsets and basis rows are computed once, into a
// table beside the stage. Tiles are disjoint, so a block writes its result
// over its input. The product runs on the tensor cores as 3xTF32
// (mma.sync m16n8k8, see wide_common.cuh): 8 warps, each 16 rows of op(G)
// against 8-32 columns. Prologues on the staged tile: the first group of a
// chain starts from |0...0> (no input read), the first group of each
// spectrum layer multiplies in the RZ phase, and the backward's first
// group undoes the ring signs; the ring signs of the last group are its
// epilogue. The signs come from the parity of row & rotl_w(row, r), so no
// sign table is read.
//
// Backward design. Per group, three launches: wide_group_mma_kernel with
// NRHS = 2 rebuilds the state in place and writes G^H c into a second
// cotangent buffer (the same op(G), two right-hand sides, in tiles half as
// wide as the forward's at D >= 64 to fit beside G); then
// wide_dg_mma_kernel forms dG from the cotangent before the push and the
// rebuilt state: a (D x D) product over all ncols columns on the same
// tensor-core path, each block one (<= 64 x 64) tile of dG over one range
// of 32-column tiles (split-K, about one block an SM), its partial written
// to a scratch of (nsplit, D, D, 2) floats; and
// wide_dg_reduce_kernel sums the partials over the splits in a fixed
// order. No atomics: a run gives the same bits every time. dG stays a
// launch of its own: fused into the rebuild, each persistent block would
// carry a D x D partial over its tiles, 128 registers a thread at D = 128
// on top of the product's, or G would have to leave shared memory. Between
// layers wide_unencode_kernel undoes the phase on state and cotangent and
// adds the phase gradient.
//
// Every launch after the first of a chain call is a programmatic
// dependent launch (Hopper): it starts while the kernel before it drains
// its last tiles and stages its G, and waits for that kernel's writes
// before it reads a plane.
//
// The monolithic chain of wide_mono.cu (#9/#10) runs the same units
// (group_mma, dg_mma, dg_reduce_chunk) on the same tiles and splits, pass
// by pass inside one cooperative launch, so it gives these kernels' bits.
//
// What bounds it on this card. Per sublayer the groups do
// 8 ncols D^2 = 8 B 2^w sum_g 2^(s_g) flops: 671 MFLOP at w=16, B=10
// (groups 6, 5, 5), 21.5 GFLOP at w=20, B=8 (7, 7, 6). As 3xTF32 each is
// three TF32 products, 165 TFLOP/s effective at the 495 TFLOP/s dense TF32
// rate (a sublayer's 21.5 GFLOP in 130 us). But mma.sync, the warp-level
// instruction used here, ran at about a quarter of that rate on an H100:
// the group products and dG product of every shape timed settled at 0.24-
// 0.26 m16n8k8 TF32 instructions a clock an SM, with no change from more
// warps, unrolling, fewer instructions or interleaved accumulators. So
// 3xTF32 over mma.sync is worth about 41 TFLOP/s, near a good SIMT
// kernel's 37 TFLOP/s (P5's first, SIMT design), and wgmma (the full TF32
// rate) is the next step: P5 (probes.cu) now runs its 3xTF32 products on
// wgmma, and tools/wide_probe.py prints the rate it issues them at, in
// m16n8k8 instructions of the same work a clock an SM beside this 0.25. The planes move 2 x 8 B per amplitude per group (a
// 2^20-amplitude state at B = 8 is 64 MB read and 64 MB written a group
// launch, 38 us from device memory), behind the arithmetic at 20 wires.
// At 16 wires, B = 10 (5 MB a state, held in L2) a launch is a few
// microseconds of arithmetic over 160-700 tiles, so the spread of tiles
// over the 132 SMs and each launch's start set the pace; fusing a
// sublayer's groups into one launch is the next step there.
//
// Indices are 64-bit: d B passes 2^31 at w=20 from B=2048.
//
// Plain C interface (bound with ctypes): each entry launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// first launch error (cudaGetLastError()).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <mutex>
#include <vector>

#include "chain_common.cuh"
#include "wide_common.cuh"

namespace {

// Persistent group product blocks (group_mma).
template <int NRHS, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    wide_group_mma_kernel(const float* in0r, const float* in0i, float* out0r,
                          float* out0i, const float* in1r, const float* in1i,
                          float* out1r, float* out1i,
                          const float* __restrict__ gr,
                          const float* __restrict__ gi,
                          const float* __restrict__ phr,
                          const float* __restrict__ phi, int zero_in,
                          int adjoint, int sign_in, int sign_out, int size,
                          int wires, long long post_b, int batch,
                          long long ncols, ColTiles ct, int g_granule) {
  extern __shared__ float4 smem4[];
  group_mma<NRHS, DP>(reinterpret_cast<float*>(smem4), in0r, in0i, out0r,
                      out0i, in1r, in1i, out1r, out1i, gr, gi, phr, phi,
                      zero_in, adjoint, sign_in, sign_out, size, wires,
                      post_b, batch, ncols, ct, g_granule);
}

// One unit of the dG product a block (dg_mma): block (tile, split) writes
// part[split][x][y][re, im].
template <int TW>
__global__ void __launch_bounds__(kMmaThreads)
    wide_dg_mma_kernel(const float* __restrict__ cr,
                       const float* __restrict__ ci,
                       const float* __restrict__ sr,
                       const float* __restrict__ si, float* __restrict__ part,
                       int sign_c, int size, int wires, long long post_b,
                       int batch, long long ncols, ColTiles ct,
                       long long per_split) {
  extern __shared__ float4 smem4[];
  dg_mma<TW>(reinterpret_cast<float*>(smem4), blockIdx.x, cr, ci, sr, si,
             part, sign_c, size, wires, post_b, batch, ncols, ct, per_split);
}

// dG's fixed-order sum over the splits, one 32-entry chunk a block
// (dg_reduce_chunk, which #10 runs too).
__global__ void __launch_bounds__(kMmaThreads)
    wide_dg_reduce_kernel(const float2* __restrict__ part,
                          float* __restrict__ dgr, float* __restrict__ dgi,
                          int n, int nsplit) {
  __shared__ float2 sums[8 * 32];
  dependents_may_start();
  wait_for_prior_grid();
  dg_reduce_chunk(blockIdx.x, part, dgr, dgi, n, nsplit, sums);
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
  dependents_may_start();
  wait_for_prior_grid();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  unencode_at(i, pr, pi, sr, si, cr, ci, dpr, dpi, first);
}

// Blocks of `kernel` (kMmaThreads threads, `smem` bytes of dynamic shared
// memory) the card holds at once, asked once a kernel and device, with the
// shared-memory opt-in set.
struct Fit {
  const void* kernel;
  int device;
  int blocks;
};
std::mutex g_fit_mu;
std::vector<Fit> g_fit;

cudaError_t resident_blocks(const void* kernel, size_t smem, int device,
                            int* blocks) {
  std::lock_guard<std::mutex> lock(g_fit_mu);
  for (const Fit& f : g_fit)
    if (f.kernel == kernel && f.device == device) {
      *blocks = f.blocks;
      return cudaSuccess;
    }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  g_fit.push_back({kernel, device, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Launches `kernel` on `stream`; after_own: the stream's last launch is one
// of this file's, so this one may start early (programmatic dependent
// launch: the kernels wait for it before touching the planes). The first
// launch of a chain call follows PyTorch's work and starts after it.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid,
                   unsigned threads, size_t smem, cudaStream_t stream,
                   bool after_own, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = after_own ? &attr : nullptr;
  cfg.numAttrs = after_own ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int NRHS, int DP>
cudaError_t launch_group_dp(const float* in0r, const float* in0i,
                            float* out0r, float* out0i, const float* in1r,
                            const float* in1i, float* out1r, float* out1i,
                            const float* gr, const float* gi,
                            const float* phr, const float* phi, int zero_in,
                            int adjoint, int sign_in, int sign_out, int size,
                            int wires, long long post_b, int batch,
                            long long ncols, bool aligned, int device,
                            cudaStream_t stream, bool after_own) {
  using S = MmaShape<NRHS, DP>;
  int fit = 0;
  cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(wide_group_mma_kernel<NRHS, DP>),
      S::kSmem, device, &fit);
  if (err != cudaSuccess) return err;
  const ColTiles ct = col_tiles(S::kTn, post_b, ncols, aligned);
  const int g_granule = g_granule_for(1 << size, aligned);
  const long long grid = ct.ntiles < fit ? ct.ntiles : fit;
  return launch(wide_group_mma_kernel<NRHS, DP>,
                static_cast<unsigned>(grid), kMmaThreads, S::kSmem, stream,
                after_own, in0r, in0i, out0r, out0i, in1r, in1i, out1r, out1i,
                gr, gi, phr, phi, zero_in, adjoint, sign_in, sign_out, size,
                wires, post_b, batch, ncols, ct, g_granule);
}

template <int NRHS>
cudaError_t launch_group(const float* in0r, const float* in0i, float* out0r,
                         float* out0i, const float* in1r, const float* in1i,
                         float* out1r, float* out1i, const float* gr,
                         const float* gi, const float* phr, const float* phi,
                         int zero_in, int adjoint, int sign_in, int sign_out,
                         int size, int wires, long long post_b, int batch,
                         long long ncols, bool aligned, int device,
                         cudaStream_t stream, bool after_own) {
  const int dim = 1 << size;
  switch (dim < 16 ? 16 : dim) {
#define WIDE_GROUP_CASE(DP)                                                  \
  case DP:                                                                   \
    return launch_group_dp<NRHS, DP>(                                        \
        in0r, in0i, out0r, out0i, in1r, in1i, out1r, out1i, gr, gi, phr,     \
        phi, zero_in, adjoint, sign_in, sign_out, size, wires, post_b,       \
        batch, ncols, aligned, device, stream, after_own);
    WIDE_GROUP_CASE(16)
    WIDE_GROUP_CASE(32)
    WIDE_GROUP_CASE(64)
    WIDE_GROUP_CASE(128)
#undef WIDE_GROUP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int TW>
cudaError_t launch_dg_tw(const float* cr, const float* ci, const float* sr,
                         const float* si, float* part, int sign_c, int size,
                         int wires, long long post_b, int batch,
                         long long ncols, const DgPlan& d, int device,
                         cudaStream_t stream) {
  int fit = 0;  // sets the shared-memory opt-in
  cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(wide_dg_mma_kernel<TW>),
      DgShape<TW>::kSmem, device, &fit);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(d.otiles) * d.nsplit;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  // the dG product and its sum always follow a rebuild and push
  return launch(wide_dg_mma_kernel<TW>, static_cast<unsigned>(blocks),
                kMmaThreads, DgShape<TW>::kSmem, stream, true, cr, ci, sr, si,
                part, sign_c, size, wires, post_b, batch, ncols, d.ct,
                d.per_split);
}

cudaError_t launch_dg(const float* cr, const float* ci, const float* sr,
                      const float* si, float* part, float* dgr, float* dgi,
                      int sign_c, int size, int wires, long long post_b,
                      int batch, long long ncols, bool aligned, int device,
                      cudaStream_t stream) {
  const int dim = 1 << size;
  const DgPlan d = dg_plan(size, post_b, ncols, aligned);
  cudaError_t err;
  if (d.tw == 64) {
    err = launch_dg_tw<64>(cr, ci, sr, si, part, sign_c, size, wires, post_b,
                           batch, ncols, d, device, stream);
  } else if (d.tw == 32) {
    err = launch_dg_tw<32>(cr, ci, sr, si, part, sign_c, size, wires, post_b,
                           batch, ncols, d, device, stream);
  } else {
    err = launch_dg_tw<16>(cr, ci, sr, si, part, sign_c, size, wires, post_b,
                           batch, ncols, d, device, stream);
  }
  if (err != cudaSuccess) return err;
  const int n = dim * dim;
  return launch(wide_dg_reduce_kernel, (n + 31) / 32, kMmaThreads, 0, stream,
                true, reinterpret_cast<const float2*>(part), dgr, dgi, n,
                d.nsplit);
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
  const bool aligned = aligned16({sr, si, g0r, g0i, g1r, g1i, g2r, g2i});
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
          grp.post_b[g], batch, grp.ncols[g], aligned, device, s,
          l > 0 || g > 0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

// Floats of dG partials the backward needs (its `part` scratch): the most
// any group takes under dg_plan's split, which #12 and #10 (wide_mono.cu)
// share.
size_t wide_chain_bwd_part_floats(int s0, int s1, int s2, int wires,
                                  int batch) {
  const int sizes[kMaxGroups] = {s0, s1, s2};
  const Groups grp = make_groups(sizes, wires, batch);
  size_t most = 0;
  for (int g = 0; g < grp.n; ++g) {
    const size_t dim = size_t{1} << grp.size[g];
    const int nsplit =
        dg_plan(grp.size[g], grp.post_b[g], grp.ncols[g], true).nsplit;
    const size_t need = static_cast<size_t>(nsplit) * dim * dim * 2;
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
  const bool aligned =
      aligned16({sr, si, cr, ci, tr, ti, g0r, g0i, g1r, g1i, g2r, g2i});
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
                            grp.ncols[g], aligned, device, s,
                            l < n_layers - 1 || g < grp.n - 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_dg(c_r, c_i, s_r, s_i, scratch, dgr[g] + gm, dgi[g] + gm,
                      sign, grp.size[g], wires, grp.post_b[g], batch,
                      grp.ncols[g], aligned, device, s);
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
      err = launch(wide_unencode_kernel, static_cast<unsigned>(blocks), 256, 0,
                   s, true, static_cast<const float*>(pr),
                   static_cast<const float*>(pi), s_r, s_i, c_r, c_i,
                   static_cast<float*>(dpr), static_cast<float*>(dpi), n,
                   first_enc ? 1 : 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      first_enc = false;
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
