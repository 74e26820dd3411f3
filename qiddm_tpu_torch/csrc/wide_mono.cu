// Wide re-uploading chain in one launch a pass (1-20 wires; the engine
// routes 11-20 here when config.wide_kernel_variant() is "monolith"): the
// monolithic forward (kernel #9) and its adjoint backward (kernel #10), for
// NVIDIA Hopper (sm_90a).
//
// #9 replaces qiddm_tpu/sim/pallas_wide_kernel.py::_fwd_kernel (reached from
// wide_fwd_planes): the whole L*k chain of one re-uploading block from
// |0...0>; every spectrum layer applies the RZ phase, then k sublayers; a
// sublayer applies each group of wide.group_sizes(w) on its bit axis, then
// the CZ ring's signs for range sel_ranges(k, w)[li].
//
// #10 replaces _bwd_kernel (reached from wide_bwd_planes): the adjoint walk
// in one launch. Per sublayer in reverse the ring signs are undone on state
// and cotangent; per group in reverse the state is rebuilt, s_in = G^H s_out,
// dG += c_out (x) conj(s_in) over every column, and the cotangent carried
// back, c_in = G^H c_out; between spectrum layers the RZ phase is undone and
// its gradient added. PyTorch's convention on real planes, as #12 (see
// wide_chain.cu); the JAX kernel pushes cotangents through G^T.
//
// Layout. The port's (d, B) float32 planes, as #11/#12 (wide_chain.cu and
// wide_common.cuh). The JAX kernel's 2^20 superstate packing, its
// identity-padded groups and its transpose cycle are the TPU's layout, not
// the function, and are not carried over.
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel on the
// caller's stream) of 256-thread blocks, at most as many as are co-resident
// on the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, queried
// with the kernel's real dynamic shared memory) and no more than the
// largest pass has work units. The state stays in device memory (8 MB a
// sample at w = 20): a 2^20 state does not fit one SM. Each pass runs one
// of the units of wide_common.cuh over its work, blockIdx.x, + gridDim.x,
// ..., and cooperative_groups' grid.sync() separates passes that read what
// another block wrote:
//   forward, per group: group_mma<1, DP> (3xTF32 on the tensor cores, G
//     staged into shared memory by cp.async, the column tiles through a
//     two-stage ring), written over its input; the first group of the
//     chain starts from |0...0>, the RZ phase is the prologue of a layer's
//     first group and the ring signs the epilogue of a sublayer's last, as
//     in #11;
//   backward, per group: group_mma<2, DP> (the state rebuilt in place, G^H
//     c into a second cotangent buffer) | sync | the units of dg_mma<TW>
//     under dg_plan, each writing its own partial | sync | the fixed-order
//     sum over the splits (dg_reduce_chunk), and after a layer's first
//     sublayer the un-encode (unencode_at) | sync.
// DP = max(16, D) is chosen per group at run time, so the kernel holds one
// branch per DP and its registers are its largest branch's (ptxas: 238
// forward, 255 backward with 44 bytes spilled; one block an SM). A second
// build for groups of at most 64 rows, capped at 128 registers for two
// blocks an SM at 16 wires, took #9 about 3% less time there on an H100
// and #10 more (it spilled 0.5 KB), so there is one build. Every block
// restages G on every pass (136 KB at D = 128, from L2); staging the next
// pass's G before the barrier, or calling the units out of line, did not
// move the times beyond the spread of in-turn pairs. The units'
// programmatic-dependent-launch hooks (griddepcontrol) are compiled out
// (PDL = false): a cooperative launch is never launched as a dependent, so
// they would only be instructions and compiler barriers in every pass.
//
// Determinism. The passes use #11/#12's column tiles (col_tiles with the
// same alignment rule), G copy width, dG split (dg_plan) and sum order
// (dg_reduce_chunk, wide_dg_reduce_kernel's body), and a tile's or unit's
// sums do not depend on which block runs it: #9 gives #11's bits and #10
// gives #12's on the same inputs, and a run gives the same bits every time
// (no float atomics). A block with no tile or unit in a pass still stages
// G, drains its copies and reaches every grid.sync() (no early return);
// grid.sync() also keeps the next pass's staging off shared memory the
// last one still reads. The planes the kernels write are read with plain
// loads and cp.async only (no __restrict__ or read-only cache on them).
//
// What bounds it on this card: #11/#12's work (see wide_chain.cu), the
// group and dG products as three TF32 tensor-core products each, at 165
// TFLOP/s effective (495 / 3) on paper and about a quarter of that with
// mma.sync. The monolith saves the launches and the host's enqueue of
// L*k*G (forward) or 3 L*k*G + L (backward) kernels, and pays a grid-wide
// barrier per pass and G's restaging instead. On an H100 a group pass
// with one column tile took about 7 us forward and 17 us backward in
// either variant (G and a tile staged from L2, the product's latency, a
// barrier or a dependent launch): #11/#12's launches already overlap, so
// the monolith saves no time where passes are short (16 wires), and at
// 20 wires the products set both.
//
// Indices are 64-bit. Plain C interface (bound with ctypes): each entry
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns the launch error (cudaErrorCooperativeLaunchTooLarge when no
// block fits an SM, cudaErrorNotSupported without cooperative launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <vector>

#include "wide_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Everything one chain call needs on the device; the backward's buffers
// are null in the forward.
struct MonoArgs {
  const float* pr;
  const float* pi;
  const float* gr[kMaxGroups];
  const float* gi[kMaxGroups];
  float* sr;  // forward: the output; backward: the state, overwritten
  float* si;
  float* cr;  // backward: the cotangent and a second buffer, overwritten
  float* ci;
  float* tr;
  float* ti;
  float* part;  // backward: the dG partials of one group
  float* dgr[kMaxGroups];
  float* dgi[kMaxGroups];
  float* dpr;
  float* dpi;
  Groups grp;
  ColTiles ct[kMaxGroups];  // each group product's column tiles
  int g_granule[kMaxGroups];
  DgPlan dg[kMaxGroups];    // backward: each dG product's split
  int wires, batch, n_layers, k;
};

// One group product over every column tile of group g, layer offset gm of
// its matrices (group_mma; DP from the group's rows).
template <int NRHS>
__device__ __forceinline__ void product_pass(
    float* smem, const MonoArgs& a, int g, size_t gm, const float* in0r,
    const float* in0i, float* out0r, float* out0i, const float* in1r,
    const float* in1i, float* out1r, float* out1i, const float* phr,
    const float* phi, int zero_in, int adjoint, int sign_in, int sign_out) {
  const int size = a.grp.size[g];
  switch (size < 4 ? 16 : 1 << size) {
#define WIDE_MONO_CASE(DP)                                                   \
  case DP:                                                                   \
    group_mma<NRHS, DP, false>(                                              \
        smem, in0r, in0i, out0r, out0i, in1r, in1i, out1r, out1i,            \
        a.gr[g] + gm, a.gi[g] + gm, phr, phi, zero_in, adjoint, sign_in,     \
        sign_out, size, a.wires, a.grp.post_b[g], a.batch, a.grp.ncols[g],   \
        a.ct[g], a.g_granule[g]);                                            \
    break;
    WIDE_MONO_CASE(16)
    WIDE_MONO_CASE(32)
    WIDE_MONO_CASE(64)
    WIDE_MONO_CASE(128)
#undef WIDE_MONO_CASE
    default:
      break;  // excluded by the host's plan
  }
}

// Every unit (dG tile, column split) of group g's dG product (dg_mma),
// each writing its partial to part[split].
__device__ __forceinline__ void dg_pass(float* smem, const MonoArgs& a,
                                        int g, const float* cr,
                                        const float* ci, const float* sr,
                                        const float* si, int sign) {
  const DgPlan& d = a.dg[g];
  const long long units = static_cast<long long>(d.otiles) * d.nsplit;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
#define WIDE_DG_ARGS                                                         \
  smem, u, cr, ci, sr, si, a.part, sign, a.grp.size[g], a.wires,             \
      a.grp.post_b[g], a.batch, a.grp.ncols[g], d.ct, d.per_split
    if (d.tw == 64) {
      dg_mma<64, false>(WIDE_DG_ARGS);
    } else if (d.tw == 32) {
      dg_mma<32, false>(WIDE_DG_ARGS);
    } else {
      dg_mma<16, false>(WIDE_DG_ARGS);
    }
#undef WIDE_DG_ARGS
  }
}

// Kernel #9: the forward chain, one group product a pass.
__global__ void __launch_bounds__(kMmaThreads)
    wide_mono_fwd_kernel(const MonoArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const Groups& grp = a.grp;
  for (int l = 0; l < a.n_layers; ++l) {
    const int li = l % a.k;
    for (int g = 0; g < grp.n; ++g) {
      if (l > 0 || g > 0) grid.sync();  // the last pass wrote every column
      const int dim = 1 << grp.size[g];
      const size_t gm = static_cast<size_t>(l) * dim * dim;
      const bool first = li == 0 && g == 0;
      product_pass<1>(smem, a, g, gm, a.sr, a.si, a.sr, a.si, nullptr,
                             nullptr, nullptr, nullptr,
                             first ? a.pr : nullptr, first ? a.pi : nullptr,
                             first && l == 0, 0, 0,
                             g == grp.n - 1 ? ring_range(li, a.wires) : 0);
    }
  }
}

// Kernel #10: the adjoint walk, three passes a group and the un-encode
// after each spectrum layer's first sublayer.
__global__ void __launch_bounds__(kMmaThreads)
    wide_mono_bwd_kernel(const MonoArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const Groups& grp = a.grp;
  float* s_r = a.sr;
  float* s_i = a.si;
  float* c_r = a.cr;
  float* c_i = a.ci;
  float* t_r = a.tr;
  float* t_i = a.ti;
  const long long n = (1LL << a.wires) * a.batch;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int first_enc = 1;
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const int li = l % a.k;
    const int r = ring_range(li, a.wires);
    for (int g = grp.n - 1; g >= 0; --g) {
      const int dim = 1 << grp.size[g];
      const size_t gm = static_cast<size_t>(l) * dim * dim;
      const int sign = g == grp.n - 1 ? r : 0;
      // the state in place: s_in = G^H s; the cotangent into t: G^H c
      product_pass<2>(smem, a, g, gm, s_r, s_i, s_r, s_i, c_r, c_i,
                             t_r, t_i, nullptr, nullptr, 0, 1, sign, 0);
      grid.sync();  // every column of s_in is written
      dg_pass(smem, a, g, c_r, c_i, s_r, s_i, sign);
      grid.sync();  // every partial is written; c_out is read for good
      const int nd = dim * dim;
      for (int chunk = blockIdx.x; chunk < (nd + 31) / 32;
           chunk += gridDim.x) {
        dg_reduce_chunk(chunk, reinterpret_cast<const float2*>(a.part),
                        a.dgr[g] + gm, a.dgi[g] + gm, nd, a.dg[g].nsplit,
                        reinterpret_cast<float2*>(smem));
        __syncthreads();  // the sums are read; the next pass stages over them
      }
      float* swap_r = c_r;
      float* swap_i = c_i;
      c_r = t_r;
      c_i = t_i;
      t_r = swap_r;
      t_i = swap_i;
      // the next group's pass touches neither part nor dG: no sync here;
      // the next dg_pass rewrites part after the next pass's sync
    }
    if (li == 0) {
      for (long long i = tid; i < n; i += stride)
        unencode_at(i, a.pr, a.pi, s_r, s_i, c_r, c_i, a.dpr, a.dpi,
                    first_enc);
      first_enc = 0;
      if (l > 0) grid.sync();  // the next pass reads every amplitude
    }
  }
}

// Launch geometry of one chain call.
struct Plan {
  const void* kernel;
  int grid;
  size_t smem;
  int blocks_per_sm;
};

// The card's residency for one kernel, device and dynamic shared memory:
// co-resident blocks an SM times SMs. Queried once each (the attributes
// and the occupancy do not change), under a lock, since ctypes releases
// Python's GIL for the call.
struct Residency {
  const void* kernel;
  int device;
  size_t smem;
  int blocks_per_sm;
  int sms;
};
// The dynamic shared memory limit set on a (kernel, device), which only
// grows: a launch needs a limit of at least its own.
struct SmemLimit {
  const void* kernel;
  int device;
  size_t smem;
};
std::mutex g_mu;
std::vector<Residency> g_residency;
std::vector<SmemLimit> g_limit;

cudaError_t residency(const void* kernel, int device, size_t smem,
                      int* blocks_per_sm, int* sms) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (const Residency& r : g_residency)
    if (r.kernel == kernel && r.device == device && r.smem == smem) {
      *blocks_per_sm = r.blocks_per_sm;
      *sms = r.sms;
      return cudaSuccess;
    }
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  Residency r = {kernel, device, smem, 0, 0};
  err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  SmemLimit* limit = nullptr;
  for (SmemLimit& l : g_limit)
    if (l.kernel == kernel && l.device == device) limit = &l;
  if (limit == nullptr || limit->smem < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (limit == nullptr)
      g_limit.push_back({kernel, device, smem});
    else
      limit->smem = smem;
  }
  // after the limit is set: the query counts the real shared memory
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.blocks_per_sm,
                                                      kernel, kMmaThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (r.blocks_per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  g_residency.push_back(r);
  *blocks_per_sm = r.blocks_per_sm;
  *sms = r.sms;
  return cudaSuccess;
}

// group_mma's column-tile width and shared memory for NRHS right-hand
// sides at DP rows.
template <int NRHS>
void mma_shape(int dp, int* tn, size_t* smem) {
  switch (dp) {
#define WIDE_MONO_SHAPE(DP)                  \
  case DP:                                   \
    *tn = MmaShape<NRHS, DP>::kTn;           \
    *smem = MmaShape<NRHS, DP>::kSmem;       \
    return;
    WIDE_MONO_SHAPE(16)
    WIDE_MONO_SHAPE(32)
    WIDE_MONO_SHAPE(64)
    WIDE_MONO_SHAPE(128)
#undef WIDE_MONO_SHAPE
  }
}

size_t dg_smem(int tw) {
  return tw == 64 ? DgShape<64>::kSmem
                  : tw == 32 ? DgShape<32>::kSmem : DgShape<16>::kSmem;
}

// Fills `a`'s column tiles, G copy widths and (backward) dG splits as
// #11/#12 take them for planes of this alignment, and plans the
// cooperative launch: its dynamic shared memory (the largest pass's) and
// a grid of at most the co-resident blocks and at most the largest pass's
// work units.
cudaError_t plan_launch(bool bwd, MonoArgs* a, bool aligned, int device,
                        Plan* p) {
  const Groups& grp = a->grp;
  if (grp.n < 1) return cudaErrorInvalidValue;
  size_t smem = 0;
  long long work = 1;
  for (int g = 0; g < grp.n; ++g) {
    const int dim = 1 << grp.size[g];
    const int dp = dim < 16 ? 16 : dim;
    if (dp > 128) return cudaErrorInvalidValue;
    int tn = 0;
    size_t need = 0;
    if (bwd)
      mma_shape<2>(dp, &tn, &need);
    else
      mma_shape<1>(dp, &tn, &need);
    a->ct[g] = col_tiles(tn, grp.post_b[g], grp.ncols[g], aligned);
    a->g_granule[g] = g_granule_for(dim, aligned);
    if (need > smem) smem = need;
    if (a->ct[g].ntiles > work) work = a->ct[g].ntiles;
    if (bwd) {
      const DgPlan d = dg_plan(grp.size[g], grp.post_b[g], grp.ncols[g],
                               aligned);
      a->dg[g] = d;
      const long long units = static_cast<long long>(d.otiles) * d.nsplit;
      const long long chunks = (static_cast<long long>(dim) * dim + 31) / 32;
      if (units > work) work = units;
      if (chunks > work) work = chunks;
      if (dg_smem(d.tw) > smem) smem = dg_smem(d.tw);
    }
  }
  if (bwd) {
    const long long n = (1LL << a->wires) * a->batch;
    const long long elems = (n + kMmaThreads - 1) / kMmaThreads;
    if (elems > work) work = elems;
  }
  p->kernel = bwd ? reinterpret_cast<const void*>(wide_mono_bwd_kernel)
                  : reinterpret_cast<const void*>(wide_mono_fwd_kernel);
  p->smem = smem;
  int sms = 0;
  const cudaError_t err =
      residency(p->kernel, device, smem, &p->blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(p->blocks_per_sm) * sms;
  p->grid = static_cast<int>(work < resident ? work : resident);
  return cudaSuccess;
}

cudaError_t launch(bool bwd, MonoArgs* a, bool aligned, int device,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_launch(bwd, a, aligned, device, &p);
  if (err != cudaSuccess) return err;
  void* params[] = {a};
  err = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(kMmaThreads),
                                    params, p.smem, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

MonoArgs make_args(const void* pr, const void* pi, const void* g0r,
                   const void* g0i, const void* g1r, const void* g1i,
                   const void* g2r, const void* g2i, int s0, int s1, int s2,
                   int wires, int batch, int n_layers, int k) {
  MonoArgs a = {};
  a.pr = static_cast<const float*>(pr);
  a.pi = static_cast<const float*>(pi);
  const void* gr[kMaxGroups] = {g0r, g1r, g2r};
  const void* gi[kMaxGroups] = {g0i, g1i, g2i};
  for (int g = 0; g < kMaxGroups; ++g) {
    a.gr[g] = static_cast<const float*>(gr[g]);
    a.gi[g] = static_cast<const float*>(gi[g]);
  }
  const int sizes[kMaxGroups] = {s0, s1, s2};
  a.grp = make_groups(sizes, wires, batch);
  a.wires = wires;
  a.batch = batch;
  a.n_layers = n_layers;
  a.k = k;
  return a;
}

}  // namespace

extern "C" {

// Kernel #9: the forward chain from |0...0> in one cooperative launch.
// Arguments as wide_chain_fwd's (wide_chain.cu): n_layers = L*k sublayers,
// the RZ phase planes (pr, pi) before sublayers 0, k, 2k, ...; group g's
// matrices (gr[g], gi[g]), each (n_layers, 2^s_g, 2^s_g) float32, s_g =
// sizes[g] (0 past the last group). Writes the state planes (sr, si), each
// (2^w, batch).
int wide_mono_fwd(const void* pr, const void* pi, const void* g0r,
                  const void* g0i, const void* g1r, const void* g1i,
                  const void* g2r, const void* g2i, void* sr, void* si,
                  int s0, int s1, int s2, int wires, int batch, int n_layers,
                  int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MonoArgs a = make_args(pr, pi, g0r, g0i, g1r, g1i, g2r, g2i, s0, s1, s2,
                         wires, batch, n_layers, k);
  a.sr = static_cast<float*>(sr);
  a.si = static_cast<float*>(si);
  const bool aligned = aligned16({sr, si, g0r, g0i, g1r, g1i, g2r, g2i});
  return static_cast<int>(
      launch(false, &a, aligned, device, static_cast<cudaStream_t>(stream)));
}

// Kernel #10: the adjoint backward of wide_mono_fwd in one cooperative
// launch. Arguments as wide_chain_bwd's (wide_chain.cu): (sr, si) hold the
// forward's output and (cr, ci) the output cotangent, (tr, ti) scratch
// planes of the same shape, all four pairs overwritten; part holds
// wide_chain_bwd_part_floats() floats. Writes the group gradients
// (dg*r, dg*i), shaped as the groups, and the phase-plane gradients
// (dpr, dpi).
int wide_mono_bwd(const void* pr, const void* pi, const void* g0r,
                  const void* g0i, const void* g1r, const void* g1i,
                  const void* g2r, const void* g2i, void* sr, void* si,
                  void* cr, void* ci, void* tr, void* ti, void* part,
                  void* dg0r, void* dg0i, void* dg1r, void* dg1i,
                  void* dg2r, void* dg2i, void* dpr, void* dpi, int s0,
                  int s1, int s2, int wires, int batch, int n_layers, int k,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MonoArgs a = make_args(pr, pi, g0r, g0i, g1r, g1i, g2r, g2i, s0, s1, s2,
                         wires, batch, n_layers, k);
  a.sr = static_cast<float*>(sr);
  a.si = static_cast<float*>(si);
  a.cr = static_cast<float*>(cr);
  a.ci = static_cast<float*>(ci);
  a.tr = static_cast<float*>(tr);
  a.ti = static_cast<float*>(ti);
  a.part = static_cast<float*>(part);
  void* dgr[kMaxGroups] = {dg0r, dg1r, dg2r};
  void* dgi[kMaxGroups] = {dg0i, dg1i, dg2i};
  for (int g = 0; g < kMaxGroups; ++g) {
    a.dgr[g] = static_cast<float*>(dgr[g]);
    a.dgi[g] = static_cast<float*>(dgi[g]);
  }
  a.dpr = static_cast<float*>(dpr);
  a.dpi = static_cast<float*>(dpi);
  const bool aligned =
      aligned16({sr, si, cr, ci, tr, ti, g0r, g0i, g1r, g1i, g2r, g2i});
  return static_cast<int>(
      launch(true, &a, aligned, device, static_cast<cudaStream_t>(stream)));
}

// The grid #9 (bwd = 0) or #10 (bwd = 1) takes for one chain call on
// aligned planes, as its launch plans it: out[0] grid, out[1] co-resident
// blocks an SM. Returns a cudaError_t.
int wide_mono_plan(int bwd, int s0, int s1, int s2, int wires, int batch,
                   int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MonoArgs a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, s0, s1, s2, wires, batch,
                         1, 1);
  Plan p;
  err = plan_launch(bwd != 0, &a, true, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.blocks_per_sm;
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
