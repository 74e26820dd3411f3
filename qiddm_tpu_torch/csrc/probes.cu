// Ceiling probes for NVIDIA Hopper (sm_90a): the six pallas_calls of the
// TPU's two probe tools, as kernels that measure this card's own ceilings.
//
// They replace, in tools/bench_pallas_wide_probe.py:
//   P1 probe_vmem (:40, call :48)      -> probe_smem_kernel
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
// and its last 8 rows and writes o = head + tail = 2x. The TPU kernel reads
// a tail it never wrote, so its output is undefined; this one defines it.
// The same kernel launches as a thread-block cluster of C blocks
// (cudaLaunchKernelEx, cluster dimension C, C = 16 non-portable): each block
// fills its own scratch, and block 0 adds the tail of block C - 1's scratch,
// read through distributed shared memory (map_shared_rank). A shape the card
// cannot hold (the attribute refused, or no cluster of that shape fits)
// returns kCapacityRefused; every other error is returned as it is.
//
// P2. A transpose's cost. The TPU probe loops 50 x
// x <- transpose(transpose(x) * 1.000001) on a (128, 8192) plane in VMEM.
// No SM holds 4 MiB, so the plane and its transpose live in device memory
// (the 50 MB L2 holds both) and one cooperative launch loops n_iters times:
// y[c, r] = x[r, c] * 1.000001f through 32 x 33 shared-memory tiles,
// grid.sync(), x[r, c] = y[c, r], grid.sync(). The grid is at most the
// co-resident blocks (the occupancy query); no fit is an error, never a
// hang. Every grid.sync() sits outside the tile loops.
//
// P3. A relayout's cost. A row-major reshape of a contiguous plane is the
// identity on the flat index, so the relayout the TPU probe costs does not
// exist here. What remains, per element, n_iters times:
// v = (v * 1.000001f) * 0.999999f, written with __fmul_rn so that nvcc
// cannot fold the two constants.
//
// P5. The group product of a 20-wire state: n_iters x x <- g @ x, g (m, m),
// x (m, n), in full float32 (FMAs on the CUDA cores, no tensor cores, no
// TF32: the TPU's Precision.HIGHEST). Columns are independent, so a block
// owns a slab of W columns and runs every product itself: g (transposed,
// rows padded by 4) and the slab sit in shared memory, each thread keeps an
// 8 x 4 register tile of the product, a barrier separates reading the slab
// from writing it back. Bound by the float32 FMA rate (2 m^2 n n_iters
// flops).
//
// P4. The contraction on x's middle axis: out[a, i, c] = sum_j g[i, j]
// x[a, j, c]. One block a slice a, with P5's slab product (W = x's last
// axis). The TPU probe asked whether Mosaic lowers it; here it always runs.
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
// cudaError_t (or kCapacityRefused from probe_smem).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;                // P1 scratch row, floats
constexpr int kHeadRows = 8;               // x is (8, 128)
constexpr int kHead = kHeadRows * kLanes;  // floats of x
constexpr int kRowBytes = kLanes * 4;
constexpr int kSmemThreads = 256;
constexpr int kCapacityRefused = -1;

constexpr int kT = 32;  // P2 tile side; the block is kT x kTRows threads
constexpr int kTRows = 8;

constexpr int kRM = 8;  // P4/P5 register tile: rows x columns a thread
constexpr int kRC = 4;
constexpr int kPad = 4;  // g's transposed rows are m + kPad floats apart

constexpr int kThreads = 256;

// ---------------------------------------------------------------- P1

__global__ void __launch_bounds__(kSmemThreads)
    probe_smem_kernel(const float* __restrict__ x, float* __restrict__ o,
                      int rows) {
  extern __shared__ float4 smem4[];
  float* scratch = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tail = (rows - kHeadRows) * kLanes;
  for (int i = threadIdx.x; i < kHead; i += blockDim.x) {
    const float v = x[i];
    scratch[i] = v;
    scratch[tail + i] = v;
  }
  cluster.sync();  // every block of the cluster has filled its scratch
  if (cluster.block_rank() == 0) {
    const float* remote =
        cluster.map_shared_rank(scratch, cluster.num_blocks() - 1);
    for (int i = threadIdx.x; i < kHead; i += blockDim.x)
      o[i] = scratch[i] + remote[tail + i];
  }
  cluster.sync();  // the last block stays resident until block 0 has read
}

// ---------------------------------------------------------------- P2

// dst (src_cols, src_rows) = src (src_rows, src_cols) transposed, times
// 1.000001f when kScale; every 32 x 32 tile, grid-stride.
template <bool kScale>
__device__ __forceinline__ void transpose_pass(const float* src, float* dst,
                                               int src_rows, int src_cols,
                                               float (*tile)[kT + 1]) {
  const int tiles_c = src_cols / kT;
  const int ntiles = (src_rows / kT) * tiles_c;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = (t / tiles_c) * kT;
    const int c0 = (t % tiles_c) * kT;
    for (int j = threadIdx.y; j < kT; j += kTRows)
      tile[j][threadIdx.x] =
          src[static_cast<size_t>(r0 + j) * src_cols + c0 + threadIdx.x];
    __syncthreads();
    for (int j = threadIdx.y; j < kT; j += kTRows) {
      float v = tile[threadIdx.x][j];
      if (kScale) v = __fmul_rn(v, 1.000001f);
      dst[static_cast<size_t>(c0 + j) * src_rows + r0 + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// o and y are written and read back in the same launch: plain loads only.
__global__ void __launch_bounds__(kT * kTRows)
    probe_transpose_kernel(const float* __restrict__ x, float* o, float* y,
                           int rows, int cols, int n_iters) {
  __shared__ float tile[kT][kT + 1];
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < n_iters; ++it) {
    transpose_pass<true>(it == 0 ? x : o, y, rows, cols, tile);
    grid.sync();
    transpose_pass<false>(y, o, cols, rows, tile);
    grid.sync();
  }
}

// ---------------------------------------------------------------- P3

__global__ void __launch_bounds__(kThreads)
    probe_reshape_kernel(const float* __restrict__ x, float* __restrict__ o,
                         long long n, int n_iters) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < n_iters; ++it)
    v = __fmul_rn(__fmul_rn(v, 1.000001f), 0.999999f);
  o[i] = v;
}

// ---------------------------------------------------------------- P4, P5

// Shared memory of a slab product: g transposed (m rows of m + kPad) and an
// (m, W) slab.
size_t slab_smem(int m, int w) {
  return (static_cast<size_t>(m) * (m + kPad) + static_cast<size_t>(m) * w) *
         sizeof(float);
}

// gt[k * (m + kPad) + i] = g[i, k]; slab = src's (m, W) columns, row
// stride ld. 16-byte loads (m, W and ld are multiples of 4, the pointers
// 16-byte aligned), so a block has a quarter of the load round trips.
__device__ __forceinline__ void stage(float* gt, float* slab,
                                      const float* __restrict__ g,
                                      const float* __restrict__ src, int m,
                                      int w, long long ld) {
  for (int e = 4 * threadIdx.x; e < m * m; e += 4 * blockDim.x) {
    const float4 v = *reinterpret_cast<const float4*>(g + e);
    const int i = e / m, k = e % m;
    gt[k * (m + kPad) + i] = v.x;
    gt[(k + 1) * (m + kPad) + i] = v.y;
    gt[(k + 2) * (m + kPad) + i] = v.z;
    gt[(k + 3) * (m + kPad) + i] = v.w;
  }
  for (int e = 4 * threadIdx.x; e < m * w; e += 4 * blockDim.x) {
    const int k = e / w, c = e % w;
    *reinterpret_cast<float4*>(slab + e) =
        *reinterpret_cast<const float4*>(src + k * ld + c);
  }
}

// acc = (g @ slab) on this thread's rows r0 .. r0 + 7 and columns
// c0 .. c0 + 3, summed over k in order, one FMA a term.
__device__ __forceinline__ void slab_product(const float* gt,
                                             const float* slab, int m, int w,
                                             int r0, int c0,
                                             float (&acc)[kRM][kRC]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = 0.0f;
  const int ldg = m + kPad;
#pragma unroll 4
  for (int k = 0; k < m; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(gt + k * ldg + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(gt + k * ldg + r0 + 4);
    const float4 b = *reinterpret_cast<const float4*>(slab + k * w + c0);
    const float a[kRM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[kRC] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// Block b owns columns b W .. b W + W - 1 of the (m, n) plane.
__global__ void __launch_bounds__(kThreads)
    probe_matmul2_kernel(const float* __restrict__ g,
                                     const float* __restrict__ x,
                                     float* __restrict__ o, int m, int n,
                                     int w, int n_iters) {
  extern __shared__ float4 smem4[];
  float* gt = reinterpret_cast<float*>(smem4);
  float* slab = gt + m * (m + kPad);
  const long long col0 = static_cast<long long>(blockIdx.x) * w;
  stage(gt, slab, g, x + col0, m, w, n);
  __syncthreads();
  const int r0 = kRM * (threadIdx.x / (w / kRC));
  const int c0 = kRC * (threadIdx.x % (w / kRC));
  float acc[kRM][kRC];
  for (int it = 0; it < n_iters; ++it) {
    slab_product(gt, slab, m, w, r0, c0, acc);
    __syncthreads();  // every thread has read the slab
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      *reinterpret_cast<float4*>(slab + (r0 + i) * w + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < m * w; e += blockDim.x) {
    const int k = e / w, c = e % w;
    o[k * static_cast<long long>(n) + col0 + c] = slab[e];
  }
}

// Block a: out[a] = g @ x[a], each x[a] an (m, w) plane.
__global__ void __launch_bounds__(kThreads)
    probe_dot3d_kernel(const float* __restrict__ g,
                                   const float* __restrict__ x,
                                   float* __restrict__ o, int m, int w) {
  extern __shared__ float4 smem4[];
  float* gt = reinterpret_cast<float*>(smem4);
  float* slab = gt + m * (m + kPad);
  const long long off = static_cast<long long>(blockIdx.x) * m * w;
  stage(gt, slab, g, x + off, m, w, w);
  __syncthreads();
  const int r0 = kRM * (threadIdx.x / (w / kRC));
  const int c0 = kRC * (threadIdx.x % (w / kRC));
  float acc[kRM][kRC];
  slab_product(gt, slab, m, w, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < kRM; ++i)
    *reinterpret_cast<float4*>(o + off + (r0 + i) * w + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

// The cooperative grid of P2: co-resident blocks, at most one a tile.
cudaError_t transpose_grid(int rows, int cols, int device, int* grid) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_transpose_kernel, kT * kTRows, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = static_cast<long long>(rows / kT) * (cols / kT);
  const long long fit = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(tiles < fit ? tiles : fit);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// P1: x and o are (8, 128) float32; the scratch is smem_bytes (a multiple
// of 512, at least 16 rows) a block, in a cluster of `cluster` blocks.
// Returns kCapacityRefused when the card cannot hold that shape.
int probe_smem(const void* x, void* o, int smem_bytes, int cluster,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes % kRowBytes != 0 || smem_bytes < 2 * kHeadRows * kRowBytes ||
      cluster < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(probe_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaErrorInvalidValue) {
    cudaGetLastError();
    return kCapacityRefused;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(probe_smem_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kSmemThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, probe_smem_kernel, &cfg);
  if (err == cudaErrorInvalidClusterSize || err == cudaErrorInvalidValue) {
    cudaGetLastError();
    return kCapacityRefused;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kCapacityRefused;
  err = cudaLaunchKernelEx(&cfg, probe_smem_kernel,
                           static_cast<const float*>(x), static_cast<float*>(o),
                           smem_bytes / kRowBytes);
  if (err == cudaErrorInvalidClusterSize) {
    cudaGetLastError();
    return kCapacityRefused;
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// P2: x and o are (rows, cols), y (cols, rows) scratch; rows and cols
// multiples of 32, n_iters >= 1. One cooperative launch.
int probe_transpose(const void* x, void* o, void* y, int rows, int cols,
                    int n_iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < kT || cols < kT || rows % kT != 0 || cols % kT != 0 ||
      n_iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = transpose_grid(rows, cols, device, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(o);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &op, &yp, &rows, &cols, &n_iters};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(probe_transpose_kernel), dim3(grid),
      dim3(kT, kTRows), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// P3: x and o hold n float32.
int probe_reshape(const void* x, void* o, long long n, int n_iters,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  probe_reshape_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a block of P4/P5 needs at (m, w).
size_t probe_slab_smem_bytes(int m, int w) { return slab_smem(m, w); }

// P5: g (m, m), x and o (m, n); w columns a block (n a multiple of w).
int probe_matmul2(const void* g, const void* x, void* o, int m, int n,
                  int w, int n_iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = slab_threads(m, w);
  if (threads == 0 || n < w || n % w != 0 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slab_smem(m, w);
  err = allow_smem(probe_matmul2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_matmul2_kernel<<<n / w, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<float*>(o), m, n, w, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// P4: g (m, m), x and o (a, m, w).
int probe_dot3d(const void* g, const void* x, void* o, int a, int m, int w,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = slab_threads(m, w);
  if (threads == 0 || a < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slab_smem(m, w);
  err = allow_smem(probe_dot3d_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_dot3d_kernel<<<a, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<float*>(o), m, w);
  return static_cast<int>(cudaGetLastError());
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
