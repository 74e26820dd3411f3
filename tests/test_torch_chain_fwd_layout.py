"""The forwards of kernels #1 and #3 (``csrc/chain_regs.cuh``'s
``chain_fwd``) on the CPU: their launch plan (``gate_kernel.chain_fwd_plan``)
at every width and at the batches the card runs, the per-rank sign masks the
kernel builds from the CZ sign planes, and a float32 PyTorch emulation of the
kernel's algorithm held against the JAX package's Pallas forwards
(``_gate_chain_fwd_call`` / ``_ry_chain_fwd_call`` in interpret mode).

The emulation follows the kernel step by step: a sample's amplitude index
split into lane, warp and register bits (a thread t of the sample holds the
amplitudes (h << (lane + warp bits)) | t); the chain from |0...0>, a layer
being the encode at l % k == 0 (RZ: the phase column's complex product in
registers; RY: RY(x_j) on each wire, a real 2x2 on both planes), the gates
on wires j = 0..w-1 (index bits w-1 .. 0: the register bits first, then the
lane and warp bits) and the CZ signs; a gate on a register bit on the pairs
inside the thread, in gate_pair's term order; on a lane or warp bit the
partner thread's (t ^ 2^bit) values fetched (by shuffle, or for a warp bit
through the sample's two sets of exchange planes, used in turn) and each
thread forming only its own new row x, t_x = g_x0 b0 + g_x1 b1; the CZ signs
applied as a flip of the sign bit where the rank's mask of its plane says
-1. Only the float32 roundings of the fused multiply-adds differ from the
card.

Tolerance: 1e-5 absolute, the kernels' own bar (``KERNEL_TOL`` in
``chip_smoke.py``): unit-norm float32 states over up to 28 layers.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel, ry_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
# (wires, batch, L*k, k)
SHAPES = [(1, 1, 4, 2), (4, 16, 28, 2), (6, 10, 28, 2), (8, 10, 12, 2),
          (10, 3, 4, 2), (9, 2, 6, 3)]
# the batches chip_smoke.py and the card tests run; each width adds 2^w - 1,
# the engine's largest batch on the gate chain
BATCHES = [1, 10, 11, 16, 80]


def _warps(wires: int) -> int:
    return 1 if wires < 8 else 2 if wires == 8 else 4


def _max_samples(wires: int) -> int:
    return 4 if wires < 8 else 2


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("wires", range(1, 11))
def test_plan_covers_the_batch_in_ctas_of_four_warps(wires):
    for batch in sorted({*BATCHES, 2, 3, 5, 2**wires - 1, 1023}):
        plan = gate_kernel.chain_fwd_plan(wires, batch)
        assert plan.warps == _warps(wires)
        assert 1 <= plan.samples <= _max_samples(wires)
        assert plan.grid == -(-batch // plan.samples)
        assert plan.threads == 32 * plan.warps * plan.samples
        # a warp for each of an SM's four schedulers, unless the batch is
        # smaller: no CTA without a live sample, none with an idle slot
        # but the last
        assert plan.threads == 128 or plan.samples == batch, batch
        assert (plan.grid - 1) * plan.samples < batch


def test_plan_at_the_models_shapes():
    plan = gate_kernel.chain_fwd_plan
    # QIDDM_LL_noise's step and sampling batch, the JAX package's A/B
    # shape: 4 samples a CTA; QIDDM_PL_noise1's step and sampling batch: 2
    assert plan(6, 10) == (1, 4, 3, 128)
    assert plan(6, 16) == (1, 4, 4, 128)
    assert plan(6, 11) == (1, 4, 3, 128)
    assert plan(8, 10) == (2, 2, 5, 128)
    assert plan(8, 16) == (2, 2, 8, 128)
    # QIDDM-A's 80 rows at 10 wires, and the engine's largest batch there:
    # a CTA a sample
    assert plan(10, 80) == (4, 1, 80, 128)
    assert plan(10, 1023) == (4, 1, 1023, 128)
    # fewer samples than a CTA's slots
    assert plan(3, 2) == (1, 2, 1, 64)


@pytest.mark.parametrize("wires,batch", [(0, 1), (11, 1), (6, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(wires, batch):
    with pytest.raises(ValueError, match="no forward plan"):
        gate_kernel.chain_fwd_plan(wires, batch)


# --- the kernel's algorithm, emulated ----------------------------------------

class _Layout:
    """The kernel's split of a sample's index at ``wires`` wires."""

    def __init__(self, wires: int, batch: int):
        plan = gate_kernel.chain_fwd_plan(wires, batch)
        self.d = 2**wires
        self.lb = min(wires, 5)
        self.wb = plan.warps.bit_length() - 1
        self.xb = self.lb + self.wb  # the bits below the register bits
        self.a = 2 ** (wires - self.xb)
        self.t = 32 * plan.warps
        # index[t, h] of thread t's amplitude h; threads t >= d hold none
        t = torch.arange(self.t)[:, None]
        h = torch.arange(self.a)[None, :]
        self.index = (h << self.xb) | t
        self.holds = (t < self.d).expand(self.t, self.a)

    def load(self, plane):
        """(d, B) plane -> (B, T, A) registers, zeros where none is held."""
        vals = plane[self.index.clamp(max=self.d - 1)].permute(2, 0, 1)
        return torch.where(self.holds, vals, torch.zeros_like(vals))

    def store(self, regs):
        """(B, T, A) registers -> (d, B) plane."""
        out = regs.new_zeros((self.d, regs.shape[0]))
        out[self.index[self.holds]] = regs[:, self.holds].T
        return out

    def masks(self, signs):
        """The (k, T) sign masks the kernel stages once a CTA: bit h of rank
        t's mask of plane p is set where signs[p] is -1 at its row h."""
        rows = self.index.clamp(max=self.d - 1)
        neg = (signs[:, :, 0][:, rows] < 0) & self.holds
        return (neg.long() << torch.arange(self.a)).sum(-1)


def _pair_rows(m, s0r, s0i, s1r, s1i):
    """gate_pair: both new rows of a pair, each sum in its term order."""
    return (m[0] * s0r - m[1] * s0i + m[2] * s1r - m[3] * s1i,
            m[0] * s0i + m[1] * s0r + m[2] * s1i + m[3] * s1r,
            m[4] * s0r - m[5] * s0i + m[6] * s1r - m[7] * s1i,
            m[4] * s0i + m[5] * s0r + m[6] * s1i + m[7] * s1r)


class _Sample:
    """The registers of every sample's threads and its exchange planes."""

    def __init__(self, lay: _Layout, batch: int):
        self.lay = lay
        self.sr = torch.zeros((batch, lay.t, lay.a))
        self.si = torch.zeros_like(self.sr)
        self.sr[:, 0, 0] = 1.0  # |0...0>: amplitude 0 of rank 0
        self.xbuf = torch.zeros((2, batch, 2, lay.d))
        self.xpar = 0
        self.exchanges = 0  # warp-bit exchanges: one named barrier each

    def partner(self, bit: int):
        """The partner thread's (sr, si) for a gate on lane or warp bit
        ``bit``: a shuffle, or through the exchange planes set xpar."""
        lay = self.lay
        if bit < lay.lb:
            partner = torch.arange(lay.t) ^ (1 << bit)
            return self.sr[:, partner], self.si[:, partner]
        buf = self.xbuf[self.xpar]
        self.xpar ^= 1
        self.exchanges += 1
        rows = lay.index.clamp(max=lay.d - 1)
        buf[:, 0, rows[lay.holds]] = self.sr[:, lay.holds]
        buf[:, 1, rows[lay.holds]] = self.si[:, lay.holds]
        other = rows ^ (1 << bit)
        return buf[:, 0][:, other], buf[:, 1][:, other]

    def gate(self, m, bit: int):
        lay = self.lay
        if bit >= lay.xb:  # a register bit: gate_pair on the thread's pairs
            rb = 1 << (bit - lay.xb)
            sr, si = self.sr.clone(), self.si.clone()
            for h in range(lay.a):
                if h & rb:
                    continue
                sr[..., h], si[..., h], sr[..., h | rb], si[..., h | rb] = (
                    _pair_rows(m, self.sr[..., h], self.si[..., h],
                               self.sr[..., h | rb], self.si[..., h | rb]))
            self.sr, self.si = sr, si
            return
        osr, osi = self.partner(bit)
        x = ((torch.arange(lay.t) >> bit) & 1).bool()[None, :, None]
        pick = lambda one, zero: torch.where(x, one, zero)  # noqa: E731
        q = [pick(m[4 + e], m[e]) for e in range(4)]
        b0r, b0i = pick(osr, self.sr), pick(osi, self.si)
        b1r, b1i = pick(self.sr, osr), pick(self.si, osi)
        self.sr, self.si = (q[0] * b0r - q[1] * b0i + q[2] * b1r - q[3] * b1i,
                            q[0] * b0i + q[1] * b0r + q[2] * b1i + q[3] * b1r)

    def encode(self, c, s, bit: int):
        """RY(x) with per-sample (c, s), each (B,), on index bit ``bit``."""
        lay = self.lay
        c, s = c[:, None], s[:, None]
        if bit >= lay.xb:
            rb = 1 << (bit - lay.xb)
            sr, si = self.sr.clone(), self.si.clone()
            for h in range(lay.a):
                if h & rb:
                    continue
                h1 = h | rb
                for new, old in ((sr, self.sr), (si, self.si)):
                    new[..., h] = c * old[..., h] - s * old[..., h1]
                    new[..., h1] = s * old[..., h] + c * old[..., h1]
            self.sr, self.si = sr, si
            return
        osr, osi = self.partner(bit)
        x = ((torch.arange(lay.t) >> bit) & 1).bool()[None, :, None]
        c3, s3 = c[..., None], s[..., None]
        q0, q1 = torch.where(x, s3, c3), torch.where(x, c3, -s3)
        pick = lambda one, zero: torch.where(x, one, zero)  # noqa: E731
        self.sr = q0 * pick(osr, self.sr) + q1 * pick(self.sr, osr)
        self.si = q0 * pick(osi, self.si) + q1 * pick(self.si, osi)

    def flip(self, mask):
        """The CZ signs: the sign bit flipped where the (T,) mask says."""
        bits = ((mask[:, None] >> torch.arange(self.lay.a)) & 1).bool()
        neg = torch.where(bits, torch.tensor(-2**31, dtype=torch.int32),
                          torch.tensor(0, dtype=torch.int32))[None]
        self.sr = (self.sr.view(torch.int32) ^ neg).view(torch.float32)
        self.si = (self.si.view(torch.int32) ^ neg).view(torch.float32)


def emulate_fwd(g8, signs, k: int, wires: int, batch: int, pr=None,
                pi=None, cs=None):
    """The kernel's forward: RZ with (pr, pi) (d, B) phase planes, RY with
    cs (2w, B). Returns the (d, B) planes and the warp-bit exchanges a
    sample made."""
    lay = _Layout(wires, batch)
    st = _Sample(lay, batch)
    masks = lay.masks(signs)
    if pr is not None:
        phr, phi = lay.load(pr), lay.load(pi)
    for l in range(g8.shape[0]):
        if l % k == 0:
            if pr is not None:
                st.sr, st.si = (st.sr * phr - st.si * phi,
                                st.sr * phi + st.si * phr)
            else:
                for bit in range(wires - 1, -1, -1):
                    j = wires - 1 - bit
                    st.encode(cs[j], cs[wires + j], bit)
        for bit in range(wires - 1, -1, -1):
            st.gate(g8[l, wires - 1 - bit], bit)
        st.flip(masks[l % k])
    return lay.store(st.sr), lay.store(st.si), st.exchanges


def _gates(rng, n_layers, wires):
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32)
    return gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1],
                                         ang[..., 2]))


@pytest.mark.parametrize("wires", range(1, 11))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sign_masks_rebuild_the_sign_planes(wires, k):
    lay = _Layout(wires, 1)
    signs = gate_kernel._sign_planes_on(k, wires, torch.device("cpu"))
    masks = lay.masks(signs)
    assert masks.shape == (k, lay.t) and lay.a <= 32
    bits = ((masks[:, :, None] >> torch.arange(lay.a)) & 1).bool()
    rebuilt = torch.ones((k, lay.d))
    rebuilt[:, lay.index[lay.holds]] = torch.where(
        bits[:, lay.holds], -1.0, 1.0)
    assert torch.equal(rebuilt, signs[:, :, 0])


@pytest.mark.parametrize("w,B,n,k", SHAPES)
def test_emulated_rz_forward_matches_the_pallas_kernel(w, B, n, k):
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    rng = np.random.default_rng(w * 100 + B + 3)
    g8 = _gates(rng, n, w)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    pr, pi = torch.cos(x), torch.sin(x)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    sr, si, exchanges = emulate_fwd(g8, signs, k, w, B, pr=pr, pi=pi)
    want = jpgk._gate_chain_fwd_call(
        jnp.asarray(pr.numpy()), jnp.asarray(pi.numpy()),
        jnp.asarray(g8.numpy()), jnp.asarray(signs.numpy()), k, w, True)
    for got, ref in zip((sr, si), want):
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL
    # one exchange a gate on each warp bit, none below 8 wires
    assert exchanges == n * (_warps(w).bit_length() - 1)


@pytest.mark.parametrize("w,B,n,k", SHAPES)
def test_emulated_ry_forward_matches_the_pallas_kernel(w, B, n, k):
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    rng = np.random.default_rng(w * 100 + B + 11)
    g8 = _gates(rng, n, w)
    cs = ry_kernel.ry_cs(torch.as_tensor(2 * rng.normal(size=(B, w)),
                                         dtype=torch.float32))
    signs = gate_kernel._sign_planes_on(k, w, cs.device)
    sr, si, exchanges = emulate_fwd(g8, signs, k, w, B, cs=cs)
    want = jpgk._ry_chain_fwd_call(
        jnp.asarray(cs.numpy()), jnp.asarray(g8.numpy()),
        jnp.asarray(signs.numpy()), k, w, True)
    for got, ref in zip((sr, si), want):
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL
    # the encode's warp bits exchange too, once a re-upload
    wb = _warps(w).bit_length() - 1
    assert exchanges == (n + n // k) * wb


@pytest.mark.parametrize("w,B", [(3, 300), (7, 5), (10, 2)])
def test_emulated_forward_matches_plain(w, B):
    """Against the port's plain chains, at a batch the plan puts several
    samples a CTA in (the samples are independent: the same values)."""
    rng = np.random.default_rng(w + B)
    k, n = 2, 6
    g8 = _gates(rng, n, w)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    pr, pi = torch.cos(x), torch.sin(x)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    got = emulate_fwd(g8, signs, k, w, B, pr=pr, pi=pi)[:2]
    want = gate_kernel._chain_plain(pr, pi, g8, signs, k, w)
    for g, p in zip(got, want):
        assert (g - p).abs().max().item() <= TOL
    cs = ry_kernel.ry_cs(x[:w].T.contiguous())
    got = emulate_fwd(g8, signs, k, w, B, cs=cs)[:2]
    want = ry_kernel._ry_plain(cs, g8, signs, k, w)
    for g, p in zip(got, want):
        assert (g - p).abs().max().item() <= TOL
