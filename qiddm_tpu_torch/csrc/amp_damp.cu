// One amplitude-damping trajectory pass (the Monte-Carlo unraveling of the
// channel on every wire, in wire order) for NVIDIA Hopper (sm_90a).
//
// amp_damp_fwd_kernel replaces
// qiddm_tpu/sim/pallas_gate_kernel.py::_amp_damp_kernel (entry
// amp_damp_call_planes, wrapper trajectories.py::_amp_damp_fused) and
// computes what its twin trajectories.py::_amp_damp_xla computes. For every
// state n (d = 2^w amplitudes, wire 0 the most significant bit of the basis
// index) and each wire j = 0..w-1 in order, on the state left by wires
// 0..j-1:
//   * p1 = g * sum_{i: bit_j(i) = 1} |psi_i|^2;
//   * pick = forced ? forced[j, n] : u[j, n] < p1;
//   * bit-0 amplitudes become pick ? sqrt(g) / sqrt(max(p1, 1e-30)) * partner
//                                  : own / sqrt(max(1 - p1, 1e-30));
//   * bit-1 amplitudes become pick ? 0
//                                  : sqrt(1 - g) / sqrt(max(1 - p1, 1e-30)) * own;
// and picks[j, n] records the branch taken. The JAX package has no backward
// kernel for this pass: its gradient replays the twin with the same uniforms
// (_amp_damp_fused_bwd), and the port's wrapper replays its plain twin with
// these picks forced (qiddm_tpu_torch/sim/amp_damp_kernel.py).
//
// Layout. The trajectory route hands over (N, d) complex64 rows, N = n_traj
// x batch, sample-major (trajectories.py flattens trajectories into the
// batch, row t*B + b), and takes the same layout back for its next
// elementwise encode and its readout. The kernel reads and writes those rows
// as float2 directly: one row is one contiguous 8 d byte run, so a block's
// load and store are coalesced and no transpose to (d, N) planes is paid on
// every call, as the TPU kernel's (d, B) lane layout would need.
//
// Design. A pass never moves an amplitude between threads. The state is
// kept in registers, A amplitudes a thread, and tracked through a mask F of
// picked wires: logical amplitude i sits at physical index i ^ F. For wire
// j (bit b = w - 1 - j of the index), F holds no bit b, so P(wire = 1)
// sums the physical amplitudes with bit b set; the branch then scales
// every amplitude by a factor of its physical bit b alone:
//   * no pick: bit 0 by c0, bit 1 by c0 sqrt(1 - g);
//   * pick: bit 1 by c1 (it holds the new logical bit-0 amplitude, c1 times
//     the old bit-1 partner) and bit 0 by 0 (the new bit-1 amplitude), and
//     F ^= 1 << b;
// and the store writes physical p to index p ^ F. These are the twin's
// float32 multiplies on the same values, only not moved. So a wire costs
// one sum and no exchange, and the sum is the only step that crosses
// threads:
//   * up to 9 wires a warp owns a state (below 5 wires a state is d lanes
//     of a warp, several states a warp): 2^w / 32 amplitudes a lane (1
//     below 5 wires, 16 at 9), p1 from xor-shuffles alone, no barrier;
//     4 warps a block;
//   * at 10-12 wires a block owns a state, 16 amplitudes a thread (64-256
//     threads): each warp's xor-shuffle sum goes to a double-buffered slot,
//     one barrier a wire, and each run of 2-8 lanes of every warp then
//     loads the slots in order and sums them with a second xor-shuffle, so
//     every thread holds the same sum in the same order.
// Thread t of a state holds physical amplitudes h T + t, h < A (T threads
// a state): each load and store of a warp covers consecutive amplitudes,
// and the xor of the store stays inside aligned runs. The kernel is a
// template on w (1..12), so every wire's bit tests unroll. The sums run in
// double: the products of float32 values are exact there, so p1 does not
// depend on the order of the sum to float32 rounding and the pick u < p1
// is the same as the plain twin's (which also sums in double) except at
// ties within ~1e-16. The strength is read on the device through a pointer
// when it is a tensor, so a sweep never synchronises with the host.
// amp_damp_kernel.amp_damp_plan, in Python, lays out a call; the launcher
// refuses any other layout.
//
// What bounds it on this card. A pass reads and writes each state once:
// 2 * N * d * 8 bytes plus the w*N uniforms and picks. At the 12-wire
// bench shape (N = 1,000, w = 12) that is 65.6 MB, ~19.6 us at 3.35 TB/s;
// the arithmetic (~10 flops an amplitude a wire, ~0.5 GFLOP) is far below
// the float32 peak. The float64 sums take two float32-to-float64
// conversions an amplitude and wire (half the amplitudes at a register
// bit, all or none of a thread's at a thread bit), at 16 a clock an SM:
// ~10-20 us of the SMs at (12, 1,000), beside the bytes. A state holds 32
// KB of registers at 12 wires, so the register file holds ~5 states an SM
// and 1,000 states take two waves.
//
// Plain C interface (bound with ctypes): the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); gate_chain_error_string in gate_chain.cu names it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpBlock = 128;  // threads a block up to 9 wires: 4 warps
constexpr int kMaxAmps = 16;     // amplitudes a thread from 9 wires

// The layout of a pass at W wires: A amplitudes a thread, T threads a
// state, S states a block of BLOCK threads, WARPS warps a state.
template <int W>
struct AmpShape {
  static constexpr int D = 1 << W;
  static constexpr int A = W < 5 ? 1 : D / 32 < kMaxAmps ? D / 32 : kMaxAmps;
  static constexpr int T = D / A;
  static constexpr int WARPS = T > 32 ? T / 32 : 1;
  static constexpr int S = T > 32 ? 1 : kWarpBlock / T;
  static constexpr int BLOCK = S * T;
};

template <int W>
__global__ void __launch_bounds__(AmpShape<W>::BLOCK)
    amp_damp_fwd_kernel(const float2* __restrict__ states,
                        const float* __restrict__ u,
                        const float* __restrict__ strength_ptr,
                        float strength_val,
                        const uint8_t* __restrict__ forced,
                        float2* __restrict__ out,
                        uint8_t* __restrict__ picks, int n) {
  using Sh = AmpShape<W>;
  constexpr int D = Sh::D, A = Sh::A, T = Sh::T, WARPS = Sh::WARPS;
  constexpr int TBITS = W - (A == 16 ? 4 : A == 8 ? 3 : A == 4 ? 2
                                : A == 2 ? 1 : 0);  // log2 T
  __shared__ double red[2][WARPS];
  const int t = threadIdx.x % T;  // rank in the state
  const long long row =
      static_cast<long long>(blockIdx.x) * Sh::S + threadIdx.x / T;
  const bool live = row < n;
  const int lane = threadIdx.x & 31;
  const int warp = t >> 5;

  float2 a[A];
  const float2* src = states + row * D;
#pragma unroll
  for (int h = 0; h < A; ++h)
    a[h] = live ? src[h * T + t] : make_float2(0.0f, 0.0f);
  const float g = strength_ptr != nullptr ? *strength_ptr : strength_val;
  const float sqg = sqrtf(fmaxf(g, 0.0f));
  const float sq1g = sqrtf(fmaxf(1.0f - g, 0.0f));

  unsigned flip = 0;   // F: the physical index of logical i is i ^ F
  unsigned taken = 0;  // the picks, bit j for wire j
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int b = W - 1 - j;
    // this wire's draw or forced pick, loaded while the sum runs
    const size_t at = static_cast<size_t>(j) * n + row;
    const float uw = live && forced == nullptr ? u[at] : 0.0f;
    const bool fw = live && forced != nullptr && forced[at] != 0;
    // sum |psi|^2 over the physical amplitudes with bit b set
    double part = 0.0;
    if (b >= TBITS) {  // a register bit: half of this thread's amplitudes
#pragma unroll
      for (int h = 0; h < A; ++h)
        if ((h >> (b - TBITS)) & 1)
          part += static_cast<double>(a[h].x) * a[h].x +
                  static_cast<double>(a[h].y) * a[h].y;
    } else if ((t >> b) & 1) {  // a thread bit: all or none of them
#pragma unroll
      for (int h = 0; h < A; ++h)
        part += static_cast<double>(a[h].x) * a[h].x +
                static_cast<double>(a[h].y) * a[h].y;
    }
#pragma unroll
    for (int off = (T < 32 ? T : 32) / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if constexpr (WARPS > 1) {
      if (lane == 0) red[j & 1][warp] = part;
      __syncthreads();  // red[j & 1] is whole; red[(j + 1) & 1] is free
      part = red[j & 1][lane & (WARPS - 1)];  // each run of WARPS lanes
#pragma unroll
      for (int off = WARPS / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    const double p1d = static_cast<double>(g) * part;
    const bool pick =
        forced != nullptr ? fw : static_cast<double>(uw) < p1d;
    const float p1 = static_cast<float>(p1d);
    const float c1 = sqg * rsqrtf(fmaxf(p1, 1e-30f));
    const float c0 = rsqrtf(fmaxf(1.0f - p1, 1e-30f));
    const float c0g = c0 * sq1g;
    const float s0 = pick ? 0.0f : c0;   // physical bit b = 0
    const float s1 = pick ? c1 : c0g;    // physical bit b = 1
#pragma unroll
    for (int h = 0; h < A; ++h) {
      const bool one = b >= TBITS ? ((h >> (b - TBITS)) & 1) != 0
                                  : ((t >> b) & 1) != 0;
      const float c = one ? s1 : s0;
      a[h] = make_float2(c * a[h].x, c * a[h].y);
    }
    if (pick) {
      flip ^= 1u << b;
      taken |= 1u << j;
    }
  }

  if (live) {
    float2* dst = out + row * D;
#pragma unroll
    for (int h = 0; h < A; ++h)
      dst[static_cast<unsigned>(h * T + t) ^ flip] = a[h];
    if (t == 0)
#pragma unroll
      for (int j = 0; j < W; ++j)
        picks[static_cast<size_t>(j) * n + row] = (taken >> j) & 1;
  }
}

template <int W>
cudaError_t launch_amp(int threads, int per_block, const float2* states,
                       const float* u, const float* strength_ptr,
                       float strength, const uint8_t* forced, float2* out,
                       uint8_t* picks, int n, cudaStream_t stream) {
  using Sh = AmpShape<W>;
  if (threads != Sh::BLOCK || per_block != Sh::S) return cudaErrorInvalidValue;
  const int blocks = (n + Sh::S - 1) / Sh::S;
  amp_damp_fwd_kernel<W><<<blocks, Sh::BLOCK, 0, stream>>>(
      states, u, strength_ptr, strength, forced, out, picks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// states and out are (n, d) complex64 rows; u is (wires, n) float32; the
// strength is read from strength_ptr (a float on the device) unless it is
// null, else taken from strength; forced is (wires, n) uint8 branch picks to
// follow, or null to draw them from u; picks is (wires, n) uint8, written
// whole. threads and per_block are amp_damp_plan's block and states a
// block, which the launcher checks against its own.
int amp_damp_fwd(const void* states, const void* u, const void* strength_ptr,
                 float strength, const void* forced, void* out, void* picks,
                 int wires, int n, int threads, int per_block, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float2*>(states);
  const auto* v = static_cast<const float*>(u);
  const auto* g = static_cast<const float*>(strength_ptr);
  const auto* f = static_cast<const uint8_t*>(forced);
  auto* o = static_cast<float2*>(out);
  auto* p = static_cast<uint8_t*>(picks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wires) {
#define AMP_CASE(W)                                                      \
  case W:                                                                \
    err = launch_amp<W>(threads, per_block, s, v, g, strength, f, o, p, n, \
                        st);                                             \
    break;
    AMP_CASE(1) AMP_CASE(2) AMP_CASE(3) AMP_CASE(4) AMP_CASE(5) AMP_CASE(6)
    AMP_CASE(7) AMP_CASE(8) AMP_CASE(9) AMP_CASE(10) AMP_CASE(11)
    AMP_CASE(12)
#undef AMP_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
