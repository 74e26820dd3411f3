// qsim — native C++ statevector / density-matrix simulator.
//
// The reference delegates its circuit execution to external native engines
// (PennyLane-Lightning's C++ statevector, qiskit-aer; SURVEY §2 native
// components). This is the framework's own native engine, on the host: an
// independent, deliberately simple gate-stream interpreter used as
//   * a cross-validation oracle for the card's simulator,
//   * the shot-sampling backend for the QASM bridge (aer analogue).
// It is the same source as the JAX package's engine, so both give the same
// bits (and, for a seed, the same shot counts).
//
// Conventions match qiddm_tpu_torch.sim: wire 0 is the most significant
// bit; RZ(t) = diag(e^{-it/2}, e^{it/2});
// Rot(phi,theta,omega) = RZ(omega) RY(theta) RZ(phi).
//
// Build (qiddm_tpu_torch/native/qsim.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o libqsim.so qsim.cpp

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

using cplx = std::complex<double>;

enum OpKind : int32_t {
  OP_RX = 0,
  OP_RY = 1,
  OP_RZ = 2,
  OP_ROT = 3,       // p0=phi, p1=theta, p2=omega
  OP_CZ = 4,        // wire=control, wire2=target
  OP_CNOT = 5,      // wire=control, wire2=target
  OP_PHASESHIFT = 6,        // p0=phi
  OP_CH_PHASE_DAMP = 7,     // p0=gamma (density mode only)
  OP_CH_AMP_DAMP = 8,       // p0=gamma (density mode only)
  OP_CH_DEPOL = 9,          // p0=p     (density mode only)
};

struct Op {
  int32_t kind;
  int32_t wire;
  int32_t wire2;
  double p0, p1, p2;
};

namespace {

inline void gate2x2(int kind, double p0, double p1, double p2, cplx g[2][2]) {
  switch (kind) {
    case OP_RX: {
      double c = std::cos(p0 / 2), s = std::sin(p0 / 2);
      g[0][0] = c; g[0][1] = cplx(0, -s);
      g[1][0] = cplx(0, -s); g[1][1] = c;
      break;
    }
    case OP_RY: {
      double c = std::cos(p0 / 2), s = std::sin(p0 / 2);
      g[0][0] = c; g[0][1] = -s;
      g[1][0] = s; g[1][1] = c;
      break;
    }
    case OP_RZ: {
      g[0][0] = std::exp(cplx(0, -p0 / 2)); g[0][1] = 0;
      g[1][0] = 0; g[1][1] = std::exp(cplx(0, p0 / 2));
      break;
    }
    case OP_ROT: {
      double phi = p0, theta = p1, omega = p2;
      double c = std::cos(theta / 2), s = std::sin(theta / 2);
      g[0][0] = std::exp(cplx(0, -(phi + omega) / 2)) * c;
      g[0][1] = -std::exp(cplx(0, (phi - omega) / 2)) * s;
      g[1][0] = std::exp(cplx(0, -(phi - omega) / 2)) * s;
      g[1][1] = std::exp(cplx(0, (phi + omega) / 2)) * c;
      break;
    }
    case OP_PHASESHIFT: {
      g[0][0] = 1; g[0][1] = 0;
      g[1][0] = 0; g[1][1] = std::exp(cplx(0, p0));
      break;
    }
    default:
      g[0][0] = 1; g[0][1] = 0; g[1][0] = 0; g[1][1] = 1;
  }
}

inline void apply_1q(std::vector<cplx>& st, int wires, int wire,
                     const cplx g[2][2]) {
  const int64_t dim = int64_t(1) << wires;
  const int64_t bit = int64_t(1) << (wires - 1 - wire);
  for (int64_t i = 0; i < dim; ++i) {
    if (i & bit) continue;
    const cplx a = st[i], b = st[i | bit];
    st[i] = g[0][0] * a + g[0][1] * b;
    st[i | bit] = g[1][0] * a + g[1][1] * b;
  }
}

inline void apply_cz(std::vector<cplx>& st, int wires, int c, int t) {
  const int64_t dim = int64_t(1) << wires;
  const int64_t cb = int64_t(1) << (wires - 1 - c);
  const int64_t tb = int64_t(1) << (wires - 1 - t);
  for (int64_t i = 0; i < dim; ++i)
    if ((i & cb) && (i & tb)) st[i] = -st[i];
}

inline void apply_cnot(std::vector<cplx>& st, int wires, int c, int t) {
  const int64_t dim = int64_t(1) << wires;
  const int64_t cb = int64_t(1) << (wires - 1 - c);
  const int64_t tb = int64_t(1) << (wires - 1 - t);
  for (int64_t i = 0; i < dim; ++i) {
    if ((i & cb) && !(i & tb)) {
      std::swap(st[i], st[i | tb]);
    }
  }
}

// density-matrix helpers -----------------------------------------------------

inline void dm_apply_1q(std::vector<cplx>& rho, int wires, int wire,
                        const cplx g[2][2]) {
  // rho' = G rho G^dagger : apply G to rows then G* to columns.
  const int64_t dim = int64_t(1) << wires;
  const int64_t bit = int64_t(1) << (wires - 1 - wire);
  for (int64_t col = 0; col < dim; ++col)
    for (int64_t i = 0; i < dim; ++i) {
      if (i & bit) continue;
      const cplx a = rho[i * dim + col], b = rho[(i | bit) * dim + col];
      rho[i * dim + col] = g[0][0] * a + g[0][1] * b;
      rho[(i | bit) * dim + col] = g[1][0] * a + g[1][1] * b;
    }
  for (int64_t row = 0; row < dim; ++row)
    for (int64_t j = 0; j < dim; ++j) {
      if (j & bit) continue;
      const cplx a = rho[row * dim + j], b = rho[row * dim + (j | bit)];
      rho[row * dim + j] = std::conj(g[0][0]) * a + std::conj(g[0][1]) * b;
      rho[row * dim + (j | bit)] = std::conj(g[1][0]) * a + std::conj(g[1][1]) * b;
    }
}

inline void dm_apply_kraus(std::vector<cplx>& rho, int wires, int wire,
                           const cplx ks[][2][2], int nk) {
  const int64_t dim = int64_t(1) << wires;
  std::vector<cplx> acc(dim * dim, cplx(0, 0));
  std::vector<cplx> tmp(dim * dim);
  for (int k = 0; k < nk; ++k) {
    tmp = rho;
    dm_apply_1q(tmp, wires, wire, ks[k]);
    for (int64_t i = 0; i < dim * dim; ++i) acc[i] += tmp[i];
  }
  rho = std::move(acc);
}

inline void dm_channel(std::vector<cplx>& rho, int wires, int wire, int kind,
                       double p) {
  if (kind == OP_CH_PHASE_DAMP) {
    cplx ks[2][2][2] = {{{1, 0}, {0, std::sqrt(1 - p)}},
                        {{0, 0}, {0, std::sqrt(p)}}};
    dm_apply_kraus(rho, wires, wire, ks, 2);
  } else if (kind == OP_CH_AMP_DAMP) {
    cplx ks[2][2][2] = {{{1, 0}, {0, std::sqrt(1 - p)}},
                        {{0, std::sqrt(p)}, {0, 0}}};
    dm_apply_kraus(rho, wires, wire, ks, 2);
  } else if (kind == OP_CH_DEPOL) {
    double s = std::sqrt(p / 3.0);
    cplx ks[4][2][2] = {
        {{std::sqrt(1 - p), 0}, {0, std::sqrt(1 - p)}},
        {{0, s}, {s, 0}},
        {{0, cplx(0, -s)}, {cplx(0, s), 0}},
        {{s, 0}, {0, -s}},
    };
    dm_apply_kraus(rho, wires, wire, ks, 4);
  }
}

// adjoint-gradient helpers ---------------------------------------------------

inline void mat2_mul(const cplx a[2][2], const cplx b[2][2], cplx o[2][2]) {
  o[0][0] = a[0][0] * b[0][0] + a[0][1] * b[1][0];
  o[0][1] = a[0][0] * b[0][1] + a[0][1] * b[1][1];
  o[1][0] = a[1][0] * b[0][0] + a[1][1] * b[1][0];
  o[1][1] = a[1][0] * b[0][1] + a[1][1] * b[1][1];
}

inline void mat2_adj(const cplx g[2][2], cplx o[2][2]) {
  o[0][0] = std::conj(g[0][0]); o[0][1] = std::conj(g[1][0]);
  o[1][0] = std::conj(g[0][1]); o[1][1] = std::conj(g[1][1]);
}

// number of trainable parameters an op contributes
inline int op_n_params(int kind) {
  switch (kind) {
    case OP_RX: case OP_RY: case OP_RZ: case OP_PHASESHIFT: return 1;
    case OP_ROT: return 3;
    default: return 0;
  }
}

// dU/dparam as a dense 2x2. For the axis rotations exp(-i t P/2) the
// derivative is (-i/2) P U; for Rot = RZ(omega) RY(theta) RZ(phi) the
// product rule over the three factors gives each partial.
inline void gate2x2_grad(int kind, double p0, double p1, double p2,
                         int param, cplx dg[2][2]) {
  cplx u[2][2];
  switch (kind) {
    case OP_RX: {
      gate2x2(OP_RX, p0, 0, 0, u);
      const cplx f(0, -0.5);
      dg[0][0] = f * u[1][0]; dg[0][1] = f * u[1][1];  // (-i/2) X U
      dg[1][0] = f * u[0][0]; dg[1][1] = f * u[0][1];
      break;
    }
    case OP_RY: {
      gate2x2(OP_RY, p0, 0, 0, u);
      const cplx f(0, -0.5);
      dg[0][0] = f * cplx(0, -1) * u[1][0];  // (-i/2) Y U
      dg[0][1] = f * cplx(0, -1) * u[1][1];
      dg[1][0] = f * cplx(0, 1) * u[0][0];
      dg[1][1] = f * cplx(0, 1) * u[0][1];
      break;
    }
    case OP_RZ: {
      gate2x2(OP_RZ, p0, 0, 0, u);
      const cplx f(0, -0.5);
      dg[0][0] = f * u[0][0]; dg[0][1] = f * u[0][1];  // (-i/2) Z U
      dg[1][0] = -f * u[1][0]; dg[1][1] = -f * u[1][1];
      break;
    }
    case OP_PHASESHIFT: {
      dg[0][0] = 0; dg[0][1] = 0; dg[1][0] = 0;
      dg[1][1] = cplx(0, 1) * std::exp(cplx(0, p0));  // d/dphi diag(1,e^{i phi})
      break;
    }
    case OP_ROT: {
      cplx a[2][2], b[2][2], c[2][2], t[2][2];
      gate2x2(OP_RZ, p0, 0, 0, a);   // RZ(phi)
      gate2x2(OP_RY, p1, 0, 0, b);   // RY(theta)
      gate2x2(OP_RZ, p2, 0, 0, c);   // RZ(omega);  U = C B A
      if (param == 0) {
        cplx da[2][2];
        gate2x2_grad(OP_RZ, p0, 0, 0, 0, da);
        mat2_mul(b, da, t); mat2_mul(c, t, dg);
      } else if (param == 1) {
        cplx db[2][2];
        gate2x2_grad(OP_RY, p1, 0, 0, 0, db);
        mat2_mul(db, a, t); mat2_mul(c, t, dg);
      } else {
        cplx dc[2][2];
        gate2x2_grad(OP_RZ, p2, 0, 0, 0, dc);
        mat2_mul(b, a, t); mat2_mul(dc, t, dg);
      }
      break;
    }
    default:
      dg[0][0] = dg[0][1] = dg[1][0] = dg[1][1] = 0;
  }
}

// <bra| M_{wire} |ket> restricted to a 1-wire operator M (dense 2x2),
// i.e. sum over the wire's partner pairs.
inline cplx braket_1q(const std::vector<cplx>& bra,
                      const std::vector<cplx>& ket, int wires, int wire,
                      const cplx m[2][2]) {
  const int64_t dim = int64_t(1) << wires;
  const int64_t bit = int64_t(1) << (wires - 1 - wire);
  cplx acc(0, 0);
  for (int64_t i = 0; i < dim; ++i) {
    if (i & bit) continue;
    const cplx a = ket[i], b = ket[i | bit];
    acc += std::conj(bra[i]) * (m[0][0] * a + m[0][1] * b);
    acc += std::conj(bra[i | bit]) * (m[1][0] * a + m[1][1] * b);
  }
  return acc;
}

}  // namespace

extern "C" {

// Run a gate stream on a statevector. init_amps (len 2^wires interleaved
// re/im) may be null for |0..0>. Channel ops are rejected (return -1).
// Outputs: out_state (2*2^wires doubles) may be null; out_probs (2^wires)
// may be null; out_expvals (wires) may be null.
int qsim_statevector_run(int wires, const Op* ops, int n_ops,
                         const double* init_amps, double* out_state,
                         double* out_probs, double* out_expvals) {
  const int64_t dim = int64_t(1) << wires;
  std::vector<cplx> st(dim, cplx(0, 0));
  if (init_amps) {
    for (int64_t i = 0; i < dim; ++i)
      st[i] = cplx(init_amps[2 * i], init_amps[2 * i + 1]);
  } else {
    st[0] = 1.0;
  }
  for (int o = 0; o < n_ops; ++o) {
    const Op& op = ops[o];
    switch (op.kind) {
      case OP_CZ: apply_cz(st, wires, op.wire, op.wire2); break;
      case OP_CNOT: apply_cnot(st, wires, op.wire, op.wire2); break;
      case OP_CH_PHASE_DAMP:
      case OP_CH_AMP_DAMP:
      case OP_CH_DEPOL:
        return -1;  // channels need the density-matrix entry point
      default: {
        cplx g[2][2];
        gate2x2(op.kind, op.p0, op.p1, op.p2, g);
        apply_1q(st, wires, op.wire, g);
      }
    }
  }
  if (out_state)
    for (int64_t i = 0; i < dim; ++i) {
      out_state[2 * i] = st[i].real();
      out_state[2 * i + 1] = st[i].imag();
    }
  if (out_probs)
    for (int64_t i = 0; i < dim; ++i) out_probs[i] = std::norm(st[i]);
  if (out_expvals) {
    for (int w = 0; w < wires; ++w) {
      const int64_t bit = int64_t(1) << (wires - 1 - w);
      double e = 0;
      for (int64_t i = 0; i < dim; ++i)
        e += ((i & bit) ? -1.0 : 1.0) * std::norm(st[i]);
      out_expvals[w] = e;
    }
  }
  return 0;
}

// Density-matrix run (supports channel ops). init_amps as above (pure-state
// init). out_probs = diagonal; out_expvals = PauliZ per wire.
int qsim_density_run(int wires, const Op* ops, int n_ops,
                     const double* init_amps, double* out_probs,
                     double* out_expvals) {
  const int64_t dim = int64_t(1) << wires;
  std::vector<cplx> st(dim, cplx(0, 0));
  if (init_amps) {
    for (int64_t i = 0; i < dim; ++i)
      st[i] = cplx(init_amps[2 * i], init_amps[2 * i + 1]);
  } else {
    st[0] = 1.0;
  }
  std::vector<cplx> rho(dim * dim);
  for (int64_t i = 0; i < dim; ++i)
    for (int64_t j = 0; j < dim; ++j)
      rho[i * dim + j] = st[i] * std::conj(st[j]);

  for (int o = 0; o < n_ops; ++o) {
    const Op& op = ops[o];
    switch (op.kind) {
      case OP_CZ: {
        // diagonal: rho_ij *= z_i z_j
        const int64_t cb = int64_t(1) << (wires - 1 - op.wire);
        const int64_t tb = int64_t(1) << (wires - 1 - op.wire2);
        for (int64_t i = 0; i < dim; ++i)
          for (int64_t j = 0; j < dim; ++j) {
            double zi = ((i & cb) && (i & tb)) ? -1.0 : 1.0;
            double zj = ((j & cb) && (j & tb)) ? -1.0 : 1.0;
            rho[i * dim + j] *= zi * zj;
          }
        break;
      }
      case OP_CNOT: {
        const int64_t cb = int64_t(1) << (wires - 1 - op.wire);
        const int64_t tb = int64_t(1) << (wires - 1 - op.wire2);
        auto f = [&](int64_t i) {
          return (i & cb) ? (i ^ tb) : i;
        };
        std::vector<cplx> nr(dim * dim);
        for (int64_t i = 0; i < dim; ++i)
          for (int64_t j = 0; j < dim; ++j)
            nr[f(i) * dim + f(j)] = rho[i * dim + j];
        rho = std::move(nr);
        break;
      }
      case OP_CH_PHASE_DAMP:
      case OP_CH_AMP_DAMP:
      case OP_CH_DEPOL:
        dm_channel(rho, wires, op.wire, op.kind, op.p0);
        break;
      default: {
        cplx g[2][2];
        gate2x2(op.kind, op.p0, op.p1, op.p2, g);
        dm_apply_1q(rho, wires, op.wire, g);
      }
    }
  }
  if (out_probs)
    for (int64_t i = 0; i < dim; ++i) out_probs[i] = rho[i * dim + i].real();
  if (out_expvals)
    for (int w = 0; w < wires; ++w) {
      const int64_t bit = int64_t(1) << (wires - 1 - w);
      double e = 0;
      for (int64_t i = 0; i < dim; ++i)
        e += ((i & bit) ? -1.0 : 1.0) * rho[i * dim + i].real();
      out_expvals[w] = e;
    }
  return 0;
}

// Adjoint-method Jacobian (Jones & Gacon 2020) — the capability that
// defines PennyLane-Lightning's C++ backend (diff_method="adjoint",
// SURVEY §2 native component #1): one forward pass + one backward sweep
// computes d<Z_w>/dtheta for EVERY parametrized gate, O(n_ops * dim)
// per observable instead of parameter-shift's 2*n_params circuit runs.
//
// out_expvals: (wires,) <Z_w> of the final state. out_jac: row-major
// (wires, n_params) where n_params counts RX/RY/RZ/PHASESHIFT as 1 and
// ROT as 3, in stream order. Channel ops are rejected (return -1): the
// adjoint trick needs unitarity.
int qsim_adjoint_grad(int wires, const Op* ops, int n_ops,
                      const double* init_amps, double* out_expvals,
                      double* out_jac) {
  const int64_t dim = int64_t(1) << wires;
  std::vector<cplx> psi(dim, cplx(0, 0));
  if (init_amps) {
    for (int64_t i = 0; i < dim; ++i)
      psi[i] = cplx(init_amps[2 * i], init_amps[2 * i + 1]);
  } else {
    psi[0] = 1.0;
  }
  // parameter offsets in stream order + forward pass
  std::vector<int> p_off(n_ops, 0);
  int n_params = 0;
  for (int o = 0; o < n_ops; ++o) {
    const Op& op = ops[o];
    p_off[o] = n_params;
    n_params += op_n_params(op.kind);
    switch (op.kind) {
      case OP_CZ: apply_cz(psi, wires, op.wire, op.wire2); break;
      case OP_CNOT: apply_cnot(psi, wires, op.wire, op.wire2); break;
      case OP_CH_PHASE_DAMP:
      case OP_CH_AMP_DAMP:
      case OP_CH_DEPOL:
        return -1;
      default: {
        cplx g[2][2];
        gate2x2(op.kind, op.p0, op.p1, op.p2, g);
        apply_1q(psi, wires, op.wire, g);
      }
    }
  }
  // expvals + one lambda = Z_w |psi> per observable
  std::vector<std::vector<cplx>> lam(wires, std::vector<cplx>(dim));
  for (int w = 0; w < wires; ++w) {
    const int64_t bit = int64_t(1) << (wires - 1 - w);
    double e = 0;
    for (int64_t i = 0; i < dim; ++i) {
      const double z = (i & bit) ? -1.0 : 1.0;
      lam[w][i] = z * psi[i];
      e += z * std::norm(psi[i]);
    }
    if (out_expvals) out_expvals[w] = e;
  }
  if (!out_jac) return 0;
  std::memset(out_jac, 0, sizeof(double) * size_t(wires) * size_t(n_params));
  // backward sweep: psi <- U_k^dag psi, grad = 2 Re<lam| dU_k |psi>,
  // lam <- U_k^dag lam
  for (int o = n_ops - 1; o >= 0; --o) {
    const Op& op = ops[o];
    if (op.kind == OP_CZ) {
      apply_cz(psi, wires, op.wire, op.wire2);
      for (int w = 0; w < wires; ++w)
        apply_cz(lam[w], wires, op.wire, op.wire2);
      continue;
    }
    if (op.kind == OP_CNOT) {
      apply_cnot(psi, wires, op.wire, op.wire2);
      for (int w = 0; w < wires; ++w)
        apply_cnot(lam[w], wires, op.wire, op.wire2);
      continue;
    }
    cplx g[2][2], gd[2][2];
    gate2x2(op.kind, op.p0, op.p1, op.p2, g);
    mat2_adj(g, gd);
    apply_1q(psi, wires, op.wire, gd);  // psi is now the pre-gate state
    const int np = op_n_params(op.kind);
    for (int p = 0; p < np; ++p) {
      cplx dg[2][2];
      gate2x2_grad(op.kind, op.p0, op.p1, op.p2, p, dg);
      for (int w = 0; w < wires; ++w)
        out_jac[int64_t(w) * n_params + p_off[o] + p] =
            2.0 * braket_1q(lam[w], psi, wires, op.wire, dg).real();
    }
    for (int w = 0; w < wires; ++w)
      apply_1q(lam[w], wires, op.wire, gd);
  }
  return 0;
}

// Total number of trainable parameters in a gate stream (jac column count).
int qsim_n_params(const Op* ops, int n_ops) {
  int n = 0;
  for (int o = 0; o < n_ops; ++o) n += op_n_params(ops[o].kind);
  return n;
}

// Multinomial shot sampling from a probability vector (aer analogue).
int qsim_sample_counts(const double* probs, int64_t dim, int64_t shots,
                       uint64_t seed, int64_t* out_counts) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<double> cdf(dim);
  double acc = 0;
  for (int64_t i = 0; i < dim; ++i) {
    acc += probs[i] > 0 ? probs[i] : 0;
    cdf[i] = acc;
  }
  std::memset(out_counts, 0, sizeof(int64_t) * dim);
  for (int64_t s = 0; s < shots; ++s) {
    double r = uni(rng) * acc;
    int64_t lo = 0, hi = dim - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cdf[mid] < r) lo = mid + 1; else hi = mid;
    }
    out_counts[lo] += 1;
  }
  return 0;
}

}  // extern "C"
