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
// caller's stream) of at most as many blocks as are co-resident on the card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, queried with the
// kernel's real dynamic shared memory), and no more than the largest pass
// has work units. The state stays in device memory (8 MB a sample at
// w = 20): a 2^20 state does not fit one SM. Each pass is a grid-stride
// loop over its work units, and cooperative_groups' grid.sync() separates
// passes that read what another block wrote:
//   forward, per group: the 32-column tiles of the group product
//     (group_tile, the SIMT unit of wide_common.cuh, one right-hand side),
//     written over their input; the RZ phase is the prologue of a layer's
//     first group and the ring signs the epilogue of a sublayer's last, as
//     in #11;
//   backward, per group: the tiles of the rebuild and push (group_tile with
//     two right-hand sides: the state in place, G^H c into a second
//     cotangent buffer) | sync | the units (dG tile, column split) of the dG
//     product (dg_unit), each writing its own partial | sync | the
//     fixed-order sum of the partials over the splits (dg_reduce_at), and
//     after a layer's first sublayer the un-encode (unencode_at) | sync.
// #11/#12 compute the same function on the tensor cores (group_mma,
// dg_mma), with other sums and roundings: the two variants agree within
// the kernels' tolerances, not bit for bit. No float atomics, and the work
// unit -> partial map does not depend on the grid, so a run gives the same
// bits every time. A block with no tile in a pass still reaches every
// grid.sync() (no early return). The kernels read the planes they write
// only with plain loads (no __restrict__ or read-only cache on them).
//
// Groups of different widths (at w=16: 64, 32, 32 rows) run in one kernel:
// group_tile is instantiated for every RX = D / 8 and chosen per group at
// run time, so the kernel's registers are its largest branch's. The block
// has 32 * min(8, smallest D) threads (256 from 3 wires up).
//
// What bounds it on this card: the group products' work of #11/#12 (see
// wide_chain.cu) as float32 FMAs on the CUDA cores, bound by the float32
// peak (67 TFLOP/s); the monolith saves the launches and the host's
// enqueue of L*k*G (forward) or 3 L*k*G + L (backward) kernels, and pays
// a grid-wide barrier per pass instead.
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
  long long per_split[kMaxGroups];  // the dG split of each group
  long long units[kMaxGroups];      // dG tiles x splits
  int nsplit[kMaxGroups];
  int wires, batch, n_layers, k;
};

// Every 32-column tile of one group product, grid-stride; RX chosen from
// the group's rows at run time.
template <int NRHS>
__device__ __forceinline__ void group_pass(
    float2* smem, const float* in0r, const float* in0i, float* out0r,
    float* out0i, const float* in1r, const float* in1i, float* out1r,
    float* out1i, const float* gr, const float* gi, const float* phr,
    const float* phi, int zero_in, int adjoint, int sign_in, int sign_out,
    int size, int wires, long long post_b, int batch, long long ncols) {
  const int rx = (1 << size) / (blockDim.x >> 5);
  const long long ntiles = (ncols + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    switch (rx) {
#define WIDE_MONO_CASE(RX)                                                    \
  case RX:                                                                    \
    group_tile<NRHS, RX>(t, smem, in0r, in0i, out0r, out0i, in1r, in1i,      \
                         out1r, out1i, gr, gi, phr, phi, zero_in, adjoint,   \
                         sign_in, sign_out, size, wires, post_b, batch,      \
                         ncols);                                             \
    break;
      WIDE_MONO_CASE(1)
      WIDE_MONO_CASE(2)
      WIDE_MONO_CASE(4)
      WIDE_MONO_CASE(8)
      WIDE_MONO_CASE(16)
#undef WIDE_MONO_CASE
      default:
        break;  // excluded by the host's geometry
    }
    __syncthreads();  // the next tile reuses the shared memory
  }
}

// Every unit (dG tile, column split) of one group's dG product,
// grid-stride; each writes its partial to part[split].
__device__ __forceinline__ void dg_pass(float2* smem, const float* cr,
                                        const float* ci, const float* sr,
                                        const float* si, float* part,
                                        int sign_c, int size, int wires,
                                        long long post_b, int batch,
                                        long long ncols, long long per_split,
                                        long long units) {
  const int m = dg_m(1 << size);
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    if (m == 4) {
      dg_unit<4>(u, smem, smem + kDgK * 64, cr, ci, sr, si, part, sign_c,
                 size, wires, post_b, batch, ncols, per_split);
    } else if (m == 2) {
      dg_unit<2>(u, smem, smem + kDgK * 32, cr, ci, sr, si, part, sign_c,
                 size, wires, post_b, batch, ncols, per_split);
    } else {
      dg_unit<1>(u, smem, smem + kDgK * 16, cr, ci, sr, si, part, sign_c,
                 size, wires, post_b, batch, ncols, per_split);
    }
  }
}

// Kernel #9: the forward chain, one group product a pass.
__global__ void __launch_bounds__(256, 2)
    wide_mono_fwd_kernel(const MonoArgs a) {
  extern __shared__ float2 smem2[];
  cg::grid_group grid = cg::this_grid();
  const Groups& grp = a.grp;
  for (int l = 0; l < a.n_layers; ++l) {
    const int li = l % a.k;
    for (int g = 0; g < grp.n; ++g) {
      if (l > 0 || g > 0) grid.sync();  // the last pass wrote every column
      const int dim = 1 << grp.size[g];
      const size_t gm = static_cast<size_t>(l) * dim * dim;
      const bool first = li == 0 && g == 0;
      group_pass<1>(smem2, a.sr, a.si, a.sr, a.si, nullptr, nullptr,
                    nullptr, nullptr, a.gr[g] + gm, a.gi[g] + gm,
                    first ? a.pr : nullptr, first ? a.pi : nullptr,
                    first && l == 0, 0, 0,
                    g == grp.n - 1 ? ring_range(li, a.wires) : 0,
                    grp.size[g], a.wires, grp.post_b[g], a.batch,
                    grp.ncols[g]);
    }
  }
}

// Kernel #10: the adjoint walk, three passes a group and the un-encode
// after each spectrum layer's first sublayer.
__global__ void __launch_bounds__(256, 2)
    wide_mono_bwd_kernel(const MonoArgs a) {
  extern __shared__ float2 smem2[];
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
      group_pass<2>(smem2, s_r, s_i, s_r, s_i, c_r, c_i, t_r, t_i,
                    a.gr[g] + gm, a.gi[g] + gm, nullptr, nullptr, 0, 1, sign,
                    0, grp.size[g], a.wires, grp.post_b[g], a.batch,
                    grp.ncols[g]);
      grid.sync();  // every column of s_in is written
      dg_pass(smem2, c_r, c_i, s_r, s_i, a.part, sign, grp.size[g], a.wires,
              grp.post_b[g], a.batch, grp.ncols[g], a.per_split[g],
              a.units[g]);
      grid.sync();  // every partial is written; c_out is read for good
      const int nd = dim * dim;
      for (long long t = tid; t < nd; t += stride)
        dg_reduce_at(static_cast<int>(t), a.part, a.dgr[g] + gm,
                     a.dgi[g] + gm, nd, a.nsplit[g]);
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
  int grid;
  int threads;
  size_t smem;
  int blocks_per_sm;
};

// The card's residency for one kernel, device, block and dynamic shared
// memory: co-resident blocks an SM times SMs. Queried once each (the
// attributes and the occupancy do not change), under a lock, since ctypes
// releases Python's GIL for the call.
struct Residency {
  const void* kernel;
  int device;
  int threads;
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

cudaError_t residency(const void* kernel, int device, int threads,
                      size_t smem, int* blocks_per_sm, int* sms) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (const Residency& r : g_residency)
    if (r.kernel == kernel && r.device == device && r.threads == threads &&
        r.smem == smem) {
      *blocks_per_sm = r.blocks_per_sm;
      *sms = r.sms;
      return cudaSuccess;
    }
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  Residency r = {kernel, device, threads, smem, 0, 0};
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
                                                      kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (r.blocks_per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  g_residency.push_back(r);
  *blocks_per_sm = r.blocks_per_sm;
  *sms = r.sms;
  return cudaSuccess;
}

// Fills `a`'s dG splits (backward) and plans the cooperative launch of
// `kernel`: threads, dynamic shared memory, and a grid of at most the
// co-resident blocks and at most the largest pass's work units.
cudaError_t plan_launch(const void* kernel, bool bwd, MonoArgs* a, int device,
                        Plan* p) {
  const Groups& grp = a->grp;
  int min_dim = 1 << 30;
  size_t smem = 0;
  long long work = 1;
  for (int g = 0; g < grp.n; ++g) {
    const int dim = 1 << grp.size[g];
    if (dim < min_dim) min_dim = dim;
    const size_t tile = group_smem(bwd ? 2 : 1, dim);
    if (tile > smem) smem = tile;
    const long long tiles = (grp.ncols[g] + kTile - 1) / kTile;
    if (tiles > work) work = tiles;
    if (bwd) {
      const DgSplit d = dg_split(grp.size[g], grp.ncols[g]);
      a->per_split[g] = d.per_split;
      a->nsplit[g] = d.nsplit;
      a->units[g] = static_cast<long long>(d.tiles) * d.nsplit;
      if (a->units[g] > work) work = a->units[g];
      const size_t dg = 2 * kDgK * 16 * dg_m(dim) * sizeof(float2);
      if (dg > smem) smem = dg;
    }
  }
  if (grp.n < 1 || min_dim < 2) return cudaErrorInvalidValue;
  p->threads = 32 * warps_for(min_dim);
  p->smem = smem;
  if (bwd) {
    const long long n = (1LL << a->wires) * a->batch;
    const long long elems = (n + p->threads - 1) / p->threads;
    if (elems > work) work = elems;
  }
  int sms = 0;
  const cudaError_t err =
      residency(kernel, device, p->threads, smem, &p->blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(p->blocks_per_sm) * sms;
  p->grid = static_cast<int>(work < resident ? work : resident);
  return cudaSuccess;
}

cudaError_t launch(const void* kernel, bool bwd, MonoArgs* a, int device,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_launch(kernel, bwd, a, device, &p);
  if (err != cudaSuccess) return err;
  void* params[] = {a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(p.threads),
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
  return static_cast<int>(
      launch(reinterpret_cast<const void*>(wide_mono_fwd_kernel), false, &a,
             device, static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(
      launch(reinterpret_cast<const void*>(wide_mono_bwd_kernel), true, &a,
             device, static_cast<cudaStream_t>(stream)));
}

// The grid #9 (bwd = 0) or #10 (bwd = 1) takes for one chain call, as its
// launch plans it: out[0] grid, out[1] co-resident blocks an SM. Returns a
// cudaError_t.
int wide_mono_plan(int bwd, int s0, int s1, int s2, int wires, int batch,
                   int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MonoArgs a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, s0, s1, s2, wires, batch,
                         1, 1);
  Plan p;
  err = plan_launch(bwd ? reinterpret_cast<const void*>(wide_mono_bwd_kernel)
                        : reinterpret_cast<const void*>(wide_mono_fwd_kernel),
                    bwd != 0, &a, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.blocks_per_sm;
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
