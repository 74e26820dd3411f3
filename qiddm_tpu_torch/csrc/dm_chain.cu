// Density-matrix re-uploading block, forward only, for NVIDIA Hopper
// (sm_90a).
//
// dm_chain_fwd_kernel replaces
// qiddm_tpu/sim/pallas_dm_kernel.py::_dm_fwd_kernel (entry
// dm_reupload_chain_pallas). For every sample b it starts from
// rho = |0...0><0...0| (d x d complex, d = 2^w, wire 0 = the most
// significant bit of the row and of the column index) and runs L spectrum
// layers of
//   * encode: RZ, rho[i, c] *= ph[i] conj(ph[c]) with the sample's (d,)
//     phases; or RY, per wire j the real gate R_j = [[c, -s], [s, c]]
//     (c, s = cos, sin of x_j / 2) on the row side and the column side,
//     rho -> R rho R^T (rows whose wire bit is 0 get c*own - s*partner);
//   * channel: the closed form of one of three channels on every wire, with
//     a runtime strength g (kind 0 amplitude damping, 1 depolarizing,
//     2 phase damping: the ids of pallas_dm_kernel.py's KIND_IDS); on the
//     2x2 block Q of one wire, Q[x][y] = rho[row bit x, column bit y]:
//       0: Q00 += g Q11, Q01 and Q10 *= s, Q11 *= s*s, s = sqrt(1 - g);
//       1: Q *= 1 - 4g/3, then Q00 and Q11 += (2g/3)(Q00 + Q11);
//       2: Q01 and Q10 *= s;
//   * SEL(k, CZ): for each of k layers, the layer's 2x2 gate G on every
//     wire, rho -> G rho G^dagger, then the CZ ring of range
//     r = li % (w-1) + 1 (restarting every spectrum layer) on both sides,
//     rho[i, c] *= sign(i) sign(c).
//
// Design. One sample's rho is split by rows over a thread-block cluster of
// C CTAs (C a power of two, at most 16; the wrapper's cluster_plan picks it
// per (w, B)): CTA `rank` owns rows [rank R, (rank+1) R), R = d / C, with
// every column. Every single-wire operation acts on the quadruples
// {i, i ^ bit} x {c, c ^ bit} of its wire, and operations on different
// wires commute, so a spectrum layer's first SEL layer runs as w passes,
// pass j applying encode_j, channel_j and G_{l,0,j} to each quadruple of
// wire j in registers (the RZ encode is diagonal on all wires and rides on
// the wire-0 pass); the other k-1 SEL layers are w passes each. The CZ
// signs are computed from parities, popc(i & rotl_w(i, r)) & 1, and
// multiplied in on the layer's last pass: no sign tables. A pass on a wire
// whose bit is below R pairs rows of one CTA: its R d / 4 quadruples are
// the CTA's alone. A pass on a partition bit (bit >= R, the top log2 C
// wires) pairs each owned row with a row of the partner CTA rank ^ (bit /
// R): the two split the pair's column pairs in halves, and each thread
// reads and writes all four elements of its quadruples, the partner's
// through distributed shared memory (cluster.map_shared_rank). So every
// element is read and written by one thread a pass, in place, and a pass
// needs only a barrier before it: cluster.sync() where this pass or the
// one before touches a partner's rows, __syncthreads() otherwise.
// Where the owned rows fit in a CTA's shared memory beside the encode and
// the gates (the plan's rho_in_smem: w <= 9), rho lives there from the
// first pass to the final store and never leaves the SMs. Past that (w =
// 10: 8 MB a sample) rho lives in the output buffer, the CTAs of a
// cluster still splitting its rows, and the passes go through L2: a
// route by shape, fixed by the plan before the launch. The launch is a
// cluster launch (cudaLaunchKernelEx); a shape the card cannot hold
// (cudaOccupancyMaxActiveClusters of 0) returns an error, which the wrapper
// raises. One quadruple a thread at a time, min(R d / 4, 512) threads
// (at least 32).
//
// What bounds it on this card. At QIDDM_PL_noise1's shape (w=8, b=10, L=6,
// k=2) a call does ~2 GFLOP (each pass touches all d^2 elements: a 2x2 gate
// on both sides is ~28 flops an element) and writes 5.2 MB: its bound is
// the float32 peak, ~34 us. A cluster of 8 puts 80 SMs on it (10 before,
// one a sample), each CTA holding 64 KB of rho; what is left is the 96
// passes' barriers (48 of them cluster-wide) and the partner rows'
// distributed-shared-memory traffic on the 3 partition wires.
//
// Plain C interface (bound with ctypes): the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); gate_chain_error_string in gate_chain.cu names it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
// Opt-in shared memory per block on Hopper (H100/H200).
constexpr size_t kMaxSmem = 232448;

constexpr int kMaxCluster = 16;

// Threads a CTA: one a quadruple of its rows, R d / 4, within [32, 512]
// (512: up to 128 registers a thread, the pass's quadruple in flight
// without spills).
int dm_threads(int wires, int cluster) {
  const long quads = (1L << (2 * wires - 2)) / cluster;
  if (quads >= kMaxThreads) return kMaxThreads;
  return quads > 32 ? static_cast<int>(quads) : 32;
}

size_t side_bytes(int wires, int n_layers, int ry) {
  const size_t d = size_t{1} << wires;
  const size_t enc = ry ? static_cast<size_t>(wires) : d;  // float2 each
  return enc * sizeof(float2) +
         static_cast<size_t>(n_layers) * wires * 8 * sizeof(float);
}

size_t smem_bytes(int wires, int n_layers, int ry, int cluster, int in_smem) {
  const size_t d = size_t{1} << wires;
  return side_bytes(wires, n_layers, ry) +
         (in_smem ? d * d / cluster * sizeof(float2) : 0);
}

// The 2x2 complex gate m on the pair (a, b) = (bit 0, bit 1), in the term
// order of chain_common.cuh's gate_pair.
__device__ __forceinline__ void mix(const float* m, float2& a, float2& b) {
  const float2 na = make_float2(m[0] * a.x - m[1] * a.y + m[2] * b.x - m[3] * b.y,
                                m[0] * a.y + m[1] * a.x + m[2] * b.y + m[3] * b.x);
  const float2 nb = make_float2(m[4] * a.x - m[5] * a.y + m[6] * b.x - m[7] * b.y,
                                m[4] * a.y + m[5] * a.x + m[6] * b.y + m[7] * b.x);
  a = na;
  b = nb;
}

// conj(m) on the pair: the column side of G rho G^dagger.
__device__ __forceinline__ void mix_conj(const float* m, float2& a, float2& b) {
  const float2 na = make_float2(m[0] * a.x + m[1] * a.y + m[2] * b.x + m[3] * b.y,
                                m[0] * a.y - m[1] * a.x + m[2] * b.y - m[3] * b.x);
  const float2 nb = make_float2(m[4] * a.x + m[5] * a.y + m[6] * b.x + m[7] * b.y,
                                m[4] * a.y - m[5] * a.x + m[6] * b.y - m[7] * b.x);
  a = na;
  b = nb;
}

// RY: bit 0 gets c*own - s*partner, bit 1 s*partner + c*own.
__device__ __forceinline__ void mix_ry(float c, float s, float2& a, float2& b) {
  const float2 na = make_float2(c * a.x - s * b.x, c * a.y - s * b.y);
  const float2 nb = make_float2(s * a.x + c * b.x, s * a.y + c * b.y);
  a = na;
  b = nb;
}

__device__ __forceinline__ float2 scale(float2 v, float f) {
  return make_float2(v.x * f, v.y * f);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// rho[i, c] *= E[i, c] = ph[i] * conj(ph[c]).
__device__ __forceinline__ float2 phase(const float2* ph, int i, int c,
                                        float2 v) {
  const float2 pc = ph[c];
  return cmul(v, cmul(ph[i], make_float2(pc.x, -pc.y)));
}

// Parity of the CZ ring of range r on basis index v (w wires).
__device__ __forceinline__ int ring_parity(unsigned v, int r, int wires,
                                           unsigned mask) {
  const unsigned rot = ((v << r) | (v >> (wires - r))) & mask;
  return __popc(v & rot) & 1;
}

__device__ __forceinline__ float2 flip(float2 v, int neg) {
  return neg ? make_float2(-v.x, -v.y) : v;
}

__global__ void __launch_bounds__(kMaxThreads)
    dm_chain_fwd_kernel(const float2* __restrict__ enc,
                        const float* __restrict__ g8,
                        const float* __restrict__ strength_ptr,
                        float strength_val, float2* __restrict__ out,
                        int wires, int n_layers, int k, int kind, int ry,
                        int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = 1 << wires;
  const size_t dd = static_cast<size_t>(d) * d;
  const int b = blockIdx.x / n_cta;  // the sample
  const int rows = d / n_cta;        // owned rows
  const int rbits = __ffs(rows) - 1;
  const int row0 = rank * rows;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half = d >> 1;
  const int quarter = d >> 2;
  const int nq = rows * d / 4;  // quadruples a CTA a pass
  const unsigned mask = static_cast<unsigned>(d - 1);

  float2* smem_f2 = reinterpret_cast<float2*>(smem_raw);
  float2* out_b = out + b * dd;
  float2* own = in_smem ? smem_f2 : out_b + static_cast<size_t>(row0) * d;
  float2* enc_s = in_smem ? smem_f2 + static_cast<size_t>(rows) * d
                          : smem_f2;
  const int n_enc = ry ? wires : d;
  float* gates = reinterpret_cast<float*>(enc_s + n_enc);

  // row i's first element: owned, a partner's shared memory, or device
  // memory
  auto row = [&](int i) -> float2* {
    if (!in_smem) return out_b + static_cast<size_t>(i) * d;
    const int owner = i >> rbits;
    float2* base = owner == rank ? own : cluster.map_shared_rank(own, owner);
    return base + static_cast<size_t>(i & (rows - 1)) * d;
  };

  for (size_t e = tid; e < static_cast<size_t>(rows) * d; e += nt)
    own[e] = make_float2(0.0f, 0.0f);
  for (int e = tid; e < n_enc; e += nt)
    enc_s[e] = enc[static_cast<size_t>(b) * n_enc + e];
  for (int e = tid; e < n_layers * wires * 8; e += nt) gates[e] = g8[e];
  __syncthreads();
  if (rank == 0 && tid == 0) own[0] = make_float2(1.0f, 0.0f);

  const float g = strength_ptr != nullptr ? *strength_ptr : strength_val;
  const float s_damp = sqrtf(1.0f - g);        // kinds 0 and 2
  const float s_damp2 = s_damp * s_damp;
  const float c0 = 1.0f - 4.0f * g / 3.0f;     // kind 1
  const float c1 = 2.0f * g / 3.0f;

  bool crossed = true;  // the partner's rows were touched before this pass
  const int n_spec = n_layers / k;
  for (int l = 0; l < n_spec; ++l) {
    for (int li = 0; li < k; ++li) {
      const int r = wires > 1 ? li % (wires - 1) + 1 : 0;
      for (int j = 0; j < wires; ++j) {
        const int bit = 1 << (wires - 1 - j);
        const bool cross = bit >= rows;  // a partition bit
        if (n_cta > 1 && (cross || crossed))
          cluster.sync();
        else
          __syncthreads();
        crossed = cross;
        const int side = (row0 & bit) ? 1 : 0;
        const float* m = gates + ((l * k + li) * wires + j) * 8;
        const bool first = li == 0;
        const bool signs = j == wires - 1 && wires > 1;
        float ry_c = 0.0f, ry_s = 0.0f;
        if (first && ry) {
          ry_c = enc_s[j].x;
          ry_s = enc_s[j].y;
        }
        for (int q = tid; q < nq; q += nt) {
          int i0, pc;
          if (cross) {  // owned row q / (d/4), this side's column pairs
            i0 = (row0 + (q >> (wires - 2))) & ~bit;
            pc = side * quarter + (q & (quarter - 1));
          } else {      // owned row pair q / (d/2): a 0 inserted at bit
            const int pr = q >> (wires - 1);
            i0 = row0 + (((pr & ~(bit - 1)) << 1) | (pr & (bit - 1)));
            pc = q & (half - 1);
          }
          const int i1 = i0 | bit;
          const int c0i = ((pc & ~(bit - 1)) << 1) | (pc & (bit - 1));
          const int c1i = c0i | bit;
          float2* r0 = row(i0);
          float2* r1 = row(i1);
          float2 q00 = r0[c0i];
          float2 q01 = r0[c1i];
          float2 q10 = r1[c0i];
          float2 q11 = r1[c1i];
          if (first) {
            if (ry) {
              mix_ry(ry_c, ry_s, q00, q10);  // row side
              mix_ry(ry_c, ry_s, q01, q11);
              mix_ry(ry_c, ry_s, q00, q01);  // column side
              mix_ry(ry_c, ry_s, q10, q11);
            } else if (j == 0) {
              q00 = phase(enc_s, i0, c0i, q00);
              q01 = phase(enc_s, i0, c1i, q01);
              q10 = phase(enc_s, i1, c0i, q10);
              q11 = phase(enc_s, i1, c1i, q11);
            }
            if (kind == 0) {
              q00 = make_float2(q00.x + g * q11.x, q00.y + g * q11.y);
              q01 = scale(q01, s_damp);
              q10 = scale(q10, s_damp);
              q11 = scale(q11, s_damp2);
            } else if (kind == 1) {
              const float2 t = make_float2(q00.x + q11.x, q00.y + q11.y);
              q00 = make_float2(c0 * q00.x + c1 * t.x, c0 * q00.y + c1 * t.y);
              q11 = make_float2(c0 * q11.x + c1 * t.x, c0 * q11.y + c1 * t.y);
              q01 = scale(q01, c0);
              q10 = scale(q10, c0);
            } else {
              q01 = scale(q01, s_damp);
              q10 = scale(q10, s_damp);
            }
          }
          mix(m, q00, q10);  // G rho
          mix(m, q01, q11);
          mix_conj(m, q00, q01);  // rho G^dagger
          mix_conj(m, q10, q11);
          if (signs) {
            const int p0 = ring_parity(i0, r, wires, mask);
            const int p1 = ring_parity(i1, r, wires, mask);
            const int s0 = ring_parity(c0i, r, wires, mask);
            const int s1 = ring_parity(c1i, r, wires, mask);
            q00 = flip(q00, p0 ^ s0);
            q01 = flip(q01, p0 ^ s1);
            q10 = flip(q10, p1 ^ s0);
            q11 = flip(q11, p1 ^ s1);
          }
          r0[c0i] = q00;
          r0[c1i] = q01;
          r1[c0i] = q10;
          r1[c1i] = q11;
        }
      }
    }
  }

  // the last pass's writes, the partners' included, are done; no CTA
  // leaves while a partner may still read its rows
  if (n_cta > 1)
    cluster.sync();
  else
    __syncthreads();
  if (in_smem) {
    float2* dst = out_b + static_cast<size_t>(row0) * d;
    for (size_t e = tid; e < static_cast<size_t>(rows) * d; e += nt)
      dst[e] = own[e];
  }
}

// Sets the kernel's attributes for a plan and fills cfg for `batch`
// samples; attr (one entry) must outlive cfg.
cudaError_t plan_launch(int wires, int n_layers, int ry, int cluster,
                        int in_smem, int batch, cudaStream_t stream,
                        cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const size_t smem = smem_bytes(wires, n_layers, ry, cluster, in_smem);
  cudaError_t err = allow_smem(dm_chain_fwd_kernel, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(dm_chain_fwd_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * cluster);
  cfg->blockDim = dim3(dm_threads(wires, cluster));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for the plan (cluster, in_smem); the
// wrapper checks it against its own plan before launching.
size_t dm_chain_smem_bytes(int wires, int n_layers, int ry, int cluster,
                           int in_smem) {
  return smem_bytes(wires, n_layers, ry, cluster, in_smem);
}

// enc is the (batch, d) complex64 RZ phases, or with ry the (batch, wires)
// float pairs (cos, sin) of x/2; g8 is (n_layers, wires, 8); the strength is
// read from strength_ptr (a float on the device) unless it is null, else
// taken from strength; rho_out is (batch, d, d) complex64, written whole.
// cluster (a power of two, at most 16 and at most d / 2 above 1) CTAs work
// a sample, rho in their shared memory if in_smem, else in rho_out.
int dm_chain_fwd(const void* enc, const void* g8, const void* strength_ptr,
                 float strength, void* rho_out, int wires, int batch,
                 int n_layers, int k, int kind, int ry, int cluster,
                 int in_smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 1 << wires;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      (cluster > 1 && cluster > d / 2) || batch < 1 ||
      smem_bytes(wires, n_layers, ry, cluster, in_smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = plan_launch(wires, n_layers, ry, cluster, in_smem, batch,
                    static_cast<cudaStream_t>(stream), &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, dm_chain_fwd_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, dm_chain_fwd_kernel,
                           static_cast<const float2*>(enc),
                           static_cast<const float*>(g8),
                           static_cast<const float*>(strength_ptr), strength,
                           static_cast<float2*>(rho_out), wires, n_layers, k,
                           kind, ry, in_smem);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of the plan the card holds at once (0: none, and the
// launch is refused; a negative cudaError on failure); chip_smoke.py prints
// it beside the plan.
int dm_chain_active_clusters(int wires, int n_layers, int ry, int cluster,
                             int in_smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (err == cudaSuccess)
    err = plan_launch(wires, n_layers, ry, cluster, in_smem, 1, nullptr,
                      &attr, &cfg);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, dm_chain_fwd_kernel,
                                         &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
