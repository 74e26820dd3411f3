"""The SEL chain's planes kernels #5 and #6 (``csrc/chain_regs.cuh``'s
``sel_fwd`` and ``sel_walk``) on the CPU: their launch plans
(``sel_kernel.sel_fwd_plan`` / ``sel_bwd_plan``) at every width and at the
batches the card runs, the CZ signs the kernels compute from the row index,
the GF(2) columns of the CNOT rings' maps, and a float32 PyTorch emulation
of both kernels' algorithms held against the JAX package's Pallas SEL
chain (``_sel_chain_fwd_call`` in interpret mode, and ``jax.vjp`` through
``_sel_chain``, whose backward is ``_sel_bwd_kernel`` in interpret mode) and
against the port's plain versions.

The emulation follows the kernels step by step: a sample's amplitude index
split into lane, warp and register bits (thread t of the sample holds the
amplitudes (h << (lane + warp bits)) | t; 1 to 16 warps a sample); a gate
on a register bit on the pairs inside the thread, in gate_pair's term
order; on a lane or warp bit each thread forming only its own new row x of
the pair from the partner thread's (t ^ 2^bit) values; the CZ ring a flip
of the sign bit where popc(i & rotl_w(i, r)) is odd for the thread's row i;
the CNOT ring each thread's values written to the sample's exchange plane
and row i read back from row map(i), map the XOR of its GF(2) columns over
i's set bits (the rank's bits once, each register bit's per amplitude).
The walk writes each gate's dg partials to a strip row a thread (from 11
wires first summed over each warp's lanes in the kernel's reduce-scatter
order), sums the strip's columns once a layer (four running sums over the
rows 4i + u, then (s0 + s1) + (s2 + s3)), and sums dg over the batch as the
launch does: a CTA's samples in increasing b, the cluster's CTAs in rank
order, then the clusters in order. Only the float32 roundings of the fused
multiply-adds differ from the card.

Tolerances: the forward 1e-5 absolute (``KERNEL_TOL`` in
``chip_smoke.py``: unit-norm float32 states over up to 14 layers); the
backward 1e-5 relative to max(1, max|reference|) (``BWD_TOL``: with N(0, 1)
cotangents dg sums products over all d rows and the batch).
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch import config
from qiddm_tpu_torch.sim import gate_kernel, sel_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.sel import cz_ring_signs

TOL = 1e-5
RINGS = ("cz", "cnot")
# the batches the card runs (QNN's training batch, the sampling batch, the
# trajectory route's 1,000 states, the dm route's 2,560 columns) and 2^w - 1
BATCHES = [1, 10, 16, 80, 1000, 2560]
# (wires, batch, depth) held against the JAX package
JAX_SHAPES = [(1, 1, 3), (2, 5, 3), (4, 16, 7), (6, 10, 8)]


def _warps(wires: int) -> int:
    return (1 if wires < 8 else 2 if wires == 8 else 4 if wires <= 10
            else 8 if wires == 11 else 16)


def _max_samples(wires: int) -> int:
    return 4 if wires < 8 else 2 if wires <= 10 else 1


def _capacity(wires: int) -> int:
    """The largest batch whose dg one cluster of 8 CTAs sums in the
    launch."""
    return 8 * _max_samples(wires)


# --- the plans ---------------------------------------------------------------

@pytest.mark.parametrize("wires", range(1, 13))
def test_plans_cover_the_batch(wires):
    for batch in sorted({*BATCHES, 2**wires - 1}):
        fwd = sel_kernel.sel_fwd_plan(wires, batch)
        assert fwd.warps == _warps(wires)
        assert 1 <= fwd.samples <= _max_samples(wires)
        assert fwd.grid == -(-batch // fwd.samples)
        assert fwd.threads == 32 * fwd.warps * fwd.samples
        # four warps a CTA up to 10 wires unless the batch is smaller;
        # from 11 wires a sample's own 8 or 16 warps
        assert (fwd.threads == max(128, 32 * fwd.warps)
                or fwd.samples == batch), batch
        bwd = sel_kernel.sel_bwd_plan(wires, batch)
        assert bwd.warps == _warps(wires)
        assert 1 <= bwd.samples <= _max_samples(wires)
        assert bwd.cluster in (1, 2, 4, 8)
        assert bwd.clusters == -(-batch // (bwd.samples * bwd.cluster))
        assert bwd.grid == bwd.cluster * bwd.clusters
        assert bwd.threads == 32 * bwd.warps * bwd.samples
        assert bwd.in_launch == (bwd.clusters == 1)
        assert bwd.in_launch == (batch <= _capacity(wires)), batch
        if wires <= config.KERNEL_MAX_WIRES:  # the gate chains' plans
            assert fwd == gate_kernel.chain_fwd_plan(wires, batch)
            assert bwd == gate_kernel.chain_bwd_plan(wires, batch)


def test_plans_at_the_models_shapes():
    # QNN_noise 784 8 14's training step (1 image x tau 10): 5 CTAs of 2
    # samples forward, one cluster of 8 CTAs backward, dg final in the
    # launch; its sampling batch of 16 too
    assert sel_kernel.sel_fwd_plan(8, 10) == (2, 2, 5, 128)
    for batch in (10, 16):
        p = sel_kernel.sel_bwd_plan(8, batch)
        assert (p.cluster, p.clusters, p.in_launch) == (8, 1, True)
    # Qdense's 6 wires at its sampling batch: 4 samples a CTA
    assert sel_kernel.sel_fwd_plan(6, 16) == (1, 4, 4, 128)
    # the dm route's 2,560 columns at 8 wires
    assert sel_kernel.sel_fwd_plan(8, 2560) == (2, 2, 1280, 128)
    # the trajectory route's 1,000 states at 12 wires: a CTA a state,
    # 125 clusters and a second launch
    assert sel_kernel.sel_fwd_plan(12, 1000) == (16, 1, 1000, 512)
    p = sel_kernel.sel_bwd_plan(12, 1000)
    assert (p.warps, p.samples, p.cluster, p.clusters, p.in_launch) == (
        16, 1, 8, 125, False)


@pytest.mark.parametrize("wires,batch", [(0, 1), (13, 1), (6, 0)])
def test_plans_refuse_what_the_kernels_do_not_take(wires, batch):
    with pytest.raises(ValueError, match="no SEL forward plan"):
        sel_kernel.sel_fwd_plan(wires, batch)
    with pytest.raises(ValueError, match="no SEL backward plan"):
        sel_kernel.sel_bwd_plan(wires, batch)


# --- the kernels' layout and rings ------------------------------------------

class _Layout:
    """The kernels' split of a sample's index at ``wires`` wires."""

    def __init__(self, wires: int):
        self.wires = wires
        self.d = 2**wires
        self.lb = min(wires, 5)
        self.warps = _warps(wires)
        self.wb = self.warps.bit_length() - 1
        self.xb = self.lb + self.wb  # the bits below the register bits
        self.a = 2 ** (wires - self.xb)
        self.t = 32 * self.warps
        self.warp_dg = wires >= 11
        # the strip rows summed once a layer
        self.rows = self.warps if self.warp_dg else min(self.d, self.t)
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

    def cz_mask(self, rr: int):
        """cz_mask: (T, A) booleans, True where the sign of the thread's row
        is -1 in the CZ ring of range rr."""
        i = self.index & (self.d - 1)
        rot = ((i << rr) | (i >> (self.wires - rr))) & (self.d - 1)
        popc = torch.zeros_like(i)
        for b in range(self.wires):
            popc += ((i & rot) >> b) & 1
        return (popc & 1).bool()

    def gather_rows(self, cols):
        """ring_gather's source row for each (t, h): the map's value at the
        thread's row, from the (w,) GF(2) columns: the rank's bits once,
        then each register bit's."""
        base = torch.zeros(self.t, dtype=torch.long)
        for bit in range(self.xb):
            base ^= torch.where((torch.arange(self.t) >> bit) & 1 == 1,
                                int(cols[bit]), 0)
        src = base[:, None].repeat(1, self.a)
        for kk in range(self.wires - self.xb):
            src ^= torch.where((torch.arange(self.a) >> kk) & 1 == 1,
                               int(cols[self.xb + kk]), 0)[None, :]
        return src


def _flip(x, mask):
    """The sign bit of x (B, T, A) flipped where mask (T, A) is set."""
    neg = torch.where(mask, torch.tensor(-2**31, dtype=torch.int32),
                      torch.tensor(0, dtype=torch.int32))[None]
    return (x.view(torch.int32) ^ neg).view(torch.float32)


def _ring_gather(lay, planes, cols):
    """The CNOT ring through the exchange plane: every held value written at
    its row, then each thread's row i read back from row map(i)."""
    src = lay.gather_rows(cols).clamp(max=lay.d - 1)
    rows = lay.index[lay.holds]
    out = []
    for x in planes:
        buf = x.new_zeros((x.shape[0], lay.d))
        buf[:, rows] = x[:, lay.holds]
        out.append(torch.where(lay.holds, buf[:, src], x))
    return out


@pytest.mark.parametrize("wires", range(2, 13))
def test_cz_masks_are_the_ring_signs(wires):
    """The signs the kernels compute from each row's index, at every range,
    are cz_ring_signs' (the JAX package's ring)."""
    lay = _Layout(wires)
    assert lay.a <= 32  # a mask of A bits fits a 32-bit word
    for rr in range(1, wires):
        mask = lay.cz_mask(rr)
        rebuilt = torch.ones(lay.d, dtype=torch.float64)
        rebuilt[lay.index[lay.holds]] = torch.where(
            mask[lay.holds], -1.0, 1.0).double()
        assert torch.equal(rebuilt,
                           torch.as_tensor(cz_ring_signs(wires, rr)))


@pytest.mark.parametrize("wires", range(1, 13))
def test_ring_columns_rebuild_both_maps(wires):
    """The (p, w) GF(2) columns of inv (the forward's gather) and of the
    forward map f (the backward's, ``inverse=True``) give the whole maps
    through the kernels' index split, and f undoes inv."""
    lay = _Layout(wires)
    inv_cols = sel_kernel.ring_columns(wires)
    f_cols = sel_kernel.ring_columns(wires, inverse=True)
    assert inv_cols.shape == f_cols.shape == (max(wires - 1, 1), wires)
    assert inv_cols.dtype == f_cols.dtype == np.int32
    inv = sel_kernel.ring_tables(wires, "cnot")
    f = sel_kernel.ring_tables(wires, "cnot", inverse=True)
    rows = lay.index[lay.holds]
    for q in range(inv.shape[0]):
        for cols, table in ((inv_cols[q], inv[q]), (f_cols[q], f[q])):
            src = lay.gather_rows(cols)[lay.holds]
            assert np.array_equal(src.numpy(), table[rows.numpy()])
        assert np.array_equal(f[q][inv[q]], np.arange(2**wires))


# --- the kernels' algorithms, emulated ---------------------------------------

def _fwd_gate(lay, sr, si, m, bit):
    """The forward gate on index bit ``bit``: gate_pair's rows on a register
    bit; else each thread's own row from the partner's values."""
    if bit >= lay.xb:
        rb = 1 << (bit - lay.xb)
        nr, ni = sr.clone(), si.clone()
        for h in range(lay.a):
            if h & rb:
                continue
            h1 = h | rb
            a0r, a0i = sr[..., h], si[..., h]
            a1r, a1i = sr[..., h1], si[..., h1]
            nr[..., h] = m[0] * a0r - m[1] * a0i + m[2] * a1r - m[3] * a1i
            ni[..., h] = m[0] * a0i + m[1] * a0r + m[2] * a1i + m[3] * a1r
            nr[..., h1] = m[4] * a0r - m[5] * a0i + m[6] * a1r - m[7] * a1i
            ni[..., h1] = m[4] * a0i + m[5] * a0r + m[6] * a1i + m[7] * a1r
        return nr, ni
    partner = torch.arange(lay.t) ^ (1 << bit)
    osr, osi = sr[:, partner], si[:, partner]
    x = ((torch.arange(lay.t) >> bit) & 1).bool()[None, :, None]
    pick = lambda one, zero: torch.where(x, one, zero)  # noqa: E731
    q = [pick(m[4 + e], m[e]) for e in range(4)]
    b0r, b0i = pick(osr, sr), pick(osi, si)
    b1r, b1i = pick(sr, osr), pick(si, osi)
    return (q[0] * b0r - q[1] * b0i + q[2] * b1r - q[3] * b1i,
            q[0] * b0i + q[1] * b0r + q[2] * b1i + q[3] * b1r)


def emulate_fwd(sr0, si0, g8, wires: int, ring: str):
    """Kernel #5's forward on (d, B) float32 planes."""
    lay = _Layout(wires)
    sr, si = lay.load(sr0), lay.load(si0)
    cols = sel_kernel.ring_columns(wires)
    for l in range(g8.shape[0]):
        for bit in range(wires - 1, -1, -1):  # wire j = 0..w-1
            sr, si = _fwd_gate(lay, sr, si, g8[l, wires - 1 - bit], bit)
        if wires == 1:
            continue
        q = l % (wires - 1)
        if ring == "cz":
            mask = lay.cz_mask(q + 1)
            sr, si = _flip(sr, mask), _flip(si, mask)
        else:
            sr, si = _ring_gather(lay, (sr, si), cols[q])
    return lay.store(sr), lay.store(si)


def _cmul_add(ar, ai, xr, xi, br, bi, yr, yi):
    """a x + b y, complex, in the kernel's term order."""
    return (ar * xr - ai * xi + br * yr - bi * yi,
            ar * xi + ai * xr + br * yi + bi * yr)


def _walk_gate(lay, st, m, bit):
    """One adjoint gate on index bit ``bit``: updates st = [sr, si, cr, ci]
    (each (B, T, A)) and returns the threads' 8 dg partials (B, T, 8): in
    order on a register bit, else (dg[x][x], dg[1-x][x]) in floats
    4x..4x+3 and zeros in the others."""
    sr, si, cr, ci = st
    a00r, a00i, a10r, a10i = m[0], -m[1], m[2], -m[3]
    a01r, a01i, a11r, a11i = m[4], -m[5], m[6], -m[7]
    B, T, A = sr.shape
    if bit >= lay.xb:  # a register bit: pairs in the thread
        rb = 1 << (bit - lay.xb)
        p = [sr.new_zeros((B, T)) for _ in range(8)]
        sr, si, cr, ci = (v.clone() for v in (sr, si, cr, ci))
        for h in range(A):
            if h & rb:
                continue
            h1 = h | rb
            s0r, s0i = sr[..., h], si[..., h]
            s1r, s1i = sr[..., h1], si[..., h1]
            c0r, c0i = cr[..., h], ci[..., h]
            c1r, c1i = cr[..., h1], ci[..., h1]
            t0r, t0i = _cmul_add(a00r, a00i, s0r, s0i, a01r, a01i, s1r, s1i)
            t1r, t1i = _cmul_add(a10r, a10i, s0r, s0i, a11r, a11i, s1r, s1i)
            for e, (cxr, cxi, tyr, tyi) in enumerate(
                    ((c0r, c0i, t0r, t0i), (c0r, c0i, t1r, t1i),
                     (c1r, c1i, t0r, t0i), (c1r, c1i, t1r, t1i))):
                p[2 * e] = p[2 * e] + (cxr * tyr + cxi * tyi)
                p[2 * e + 1] = p[2 * e + 1] + (cxi * tyr - cxr * tyi)
            n0 = _cmul_add(a00r, a00i, c0r, c0i, a01r, a01i, c1r, c1i)
            n1 = _cmul_add(a10r, a10i, c0r, c0i, a11r, a11i, c1r, c1i)
            sr[..., h], si[..., h] = t0r, t0i
            sr[..., h1], si[..., h1] = t1r, t1i
            cr[..., h], ci[..., h] = n0
            cr[..., h1], ci[..., h1] = n1
        return [sr, si, cr, ci], torch.stack(p, -1)
    partner = torch.arange(T) ^ (1 << bit)
    osr, osi, ocr, oci = (v[:, partner] for v in (sr, si, cr, ci))
    x = ((torch.arange(T) >> bit) & 1).bool()[None, :, None]
    pick = lambda one, zero: torch.where(x, one, zero)  # noqa: E731
    ur, ui = pick(a11r, a00r), pick(a11i, a00i)
    vr, vi = pick(a10r, a01r), pick(a10i, a01i)
    tr, ti = _cmul_add(ur, ui, sr, si, vr, vi, osr, osi)  # its own row
    q = [sr.new_zeros((B, T)) for _ in range(4)]
    for h in range(A):  # a thread's amplitudes in order
        q[0] = q[0] + (cr[..., h] * tr[..., h] + ci[..., h] * ti[..., h])
        q[1] = q[1] + (ci[..., h] * tr[..., h] - cr[..., h] * ti[..., h])
        q[2] = q[2] + (ocr[..., h] * tr[..., h] + oci[..., h] * ti[..., h])
        q[3] = q[3] + (oci[..., h] * tr[..., h] - ocr[..., h] * ti[..., h])
    nr, ni = _cmul_add(ur, ui, cr, ci, vr, vi, ocr, oci)
    x2 = x[..., 0]
    zero = torch.zeros_like(q[0])
    floats = ([torch.where(x2, zero, qq) for qq in q]
              + [torch.where(x2, qq, zero) for qq in q])
    return [tr, ti, nr, ni], torch.stack(floats, -1)


def _warp_sum(part):
    """warp_dg_store: (B, T, 8) partials -> (B, warps, 8), each warp's sum
    over its lanes in the kernel's order: a reduce-scatter over lane bits 4,
    3 and 2, then sums over bits 0 and 1; lane 4e holds entry e."""
    B, T, _ = part.shape
    v = part.reshape(B, T // 32, 32, 8)
    lane = torch.arange(32)
    b4, b3, b2 = ((lane >> s) & 1 == 1 for s in (4, 3, 2))
    v4 = [torch.where(b4, v[..., e + 4], v[..., e])
          + torch.where(b4, v[..., e], v[..., e + 4])[..., lane ^ 16]
          for e in range(4)]
    v2 = [torch.where(b3, v4[e + 2], v4[e])
          + torch.where(b3, v4[e], v4[e + 2])[..., lane ^ 8]
          for e in range(2)]
    s = (torch.where(b2, v2[1], v2[0])
         + torch.where(b2, v2[0], v2[1])[..., lane ^ 4])
    s = s + s[..., lane ^ 1]
    s = s + s[..., lane ^ 2]
    return s[..., 0::4]


def _flush(lay, strip):
    """(B, rows, 8w) strip of a layer -> (B, 8w) dg[l], as walk_flush sums
    it: entry e of a lane or warp bit's gate j from column
    8j + 4x + ((e & 1) | (((e >> 2) ^ x) & 1) << 1), x = (e >> 1) & 1, each
    column over the rows in four running sums, (s0 + s1) + (s2 + s3)."""
    src = []
    for c in range(8 * lay.wires):
        j, e = divmod(c, 8)
        x = (e >> 1) & 1
        if lay.wires - 1 - j < lay.xb:
            c = j * 8 + x * 4 + ((e & 1) | ((((e >> 2) ^ x) & 1) << 1))
        src.append(c)
    strip = strip[..., src]
    acc = [strip.new_zeros((strip.shape[0], strip.shape[2]))
           for _ in range(4)]
    for row in range(lay.rows):
        acc[row % 4] = acc[row % 4] + strip[:, row]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _batch_sum(plan, dgs):
    """(B, n) per-sample dg -> (n,) summed as the launch sums it: a CTA's
    samples in increasing b, the cluster's CTAs in rank order, then (past
    one cluster, the second launch) the clusters in order."""
    B = dgs.shape[0]
    S, C = plan.samples, plan.cluster
    parts = []
    for cta in range(plan.grid):
        b0 = cta * S
        part = dgs[b0] if b0 < B else None
        for s in range(1, min(S, B - b0)):
            part = part + dgs[b0 + s]
        parts.append(part)
    sums = []
    for cl in range(plan.clusters):
        ranks = min(C, -(-(B - cl * C * S) // S))
        v = parts[cl * C]
        for q in range(1, ranks):
            v = v + parts[cl * C + q]
        sums.append(v)
    if plan.in_launch:
        return sums[0]
    total = torch.zeros_like(sums[0])  # dg_batch_sum_kernel
    for v in sums:
        total = total + v
    return total


def emulate_walk(g8, fr, fi, gr, gi, wires: int, ring: str):
    """Kernel #6's walk on (d, B) float32 planes: (dsr, dsi, dg)."""
    lay = _Layout(wires)
    B, depth = fr.shape[1], g8.shape[0]
    st = [lay.load(v) for v in (fr, fi, gr, gi)]
    cols = sel_kernel.ring_columns(wires, inverse=True)  # f's
    dgs = fr.new_zeros((B, depth, 8 * wires))
    for l in range(depth - 1, -1, -1):
        if wires > 1:
            q = l % (wires - 1)
            if ring == "cz":
                mask = lay.cz_mask(q + 1)
                st = [_flip(v, mask) for v in st]
            else:
                st = _ring_gather(lay, st, cols[q])
        strip = fr.new_zeros((B, lay.warps if lay.warp_dg else lay.t,
                              8 * wires))
        for bit in range(wires):  # wire j = w-1 .. 0
            j = wires - 1 - bit
            st, part = _walk_gate(lay, st, g8[l, j], bit)
            strip[..., 8 * j:8 * j + 8] = (_warp_sum(part) if lay.warp_dg
                                           else part)
        dgs[:, l] = _flush(lay, strip)
    plan = sel_kernel.sel_bwd_plan(wires, B)
    dg = _batch_sum(plan, dgs.reshape(B, -1)).reshape(depth, wires, 8)
    return lay.store(st[2]), lay.store(st[3]), dg


def _inputs(w, B, depth, seed):
    """Normalized start planes (d, B), gates (depth, w, 8) and N(0, 1)
    cotangents, float32, from numpy."""
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(2, 2**w, B))
    st /= np.sqrt((st ** 2).sum(axis=(0, 1), keepdims=True))
    ang = torch.as_tensor(rng.normal(size=(depth, w, 3)), dtype=torch.float32)
    g8 = gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2]))
    sr, si = (torch.as_tensor(p, dtype=torch.float32) for p in st)
    cot = rng.normal(size=(2, 2**w, B)).astype(np.float32)
    return sr, si, g8, cot


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,B,depth", JAX_SHAPES)
def test_emulated_forward_matches_the_pallas_kernel(w, B, depth, ring):
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    sr, si, g8, _ = _inputs(w, B, depth, seed=w * 10 + B)
    got = emulate_fwd(sr, si, g8, w, ring)
    want = jpgk._sel_chain_fwd_call(
        jnp.asarray(sr.numpy()), jnp.asarray(si.numpy()),
        jnp.asarray(g8.numpy()), w, ring == "cz", True)
    for g, ref in zip(got, want):
        assert g.shape == ref.shape
        assert np.abs(g.numpy() - np.asarray(ref)).max() <= TOL


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,B,depth", JAX_SHAPES)
def test_emulated_walk_matches_the_pallas_vjp(w, B, depth, ring):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    sr, si, g8, cot = _inputs(w, B, depth, seed=w * 10 + B + 1)
    fr, fi = sel_kernel._sel_plain(sr, si, g8, w, ring)
    got = emulate_walk(g8, fr, fi, *(torch.as_tensor(c) for c in cot), w,
                       ring)
    _, vjp = jax.vjp(
        lambda a, b, c: jpgk._sel_chain(a, b, c, w, ring == "cz", True),
        jnp.asarray(sr.numpy()), jnp.asarray(si.numpy()),
        jnp.asarray(g8.numpy()))
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    for g, ref in zip(got, want):
        assert g.shape == ref.shape
        _assert_rel(g.numpy(), ref)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,B,depth", [(8, 10, 14), (11, 3, 2)])
def test_emulated_kernels_match_plain(w, B, depth, ring):
    """At QNN's training shape (8 wires, 2 warps a sample, 2 samples a CTA,
    dg summed in the launch over a cluster of 8 CTAs) and at 11 wires (8
    warps a sample, dg summed over each warp's lanes first, 3 CTAs in a
    cluster of 4), against the port's plain versions."""
    sr, si, g8, cot = _inputs(w, B, depth, seed=w + B)
    got = emulate_fwd(sr, si, g8, w, ring)
    want = sel_kernel._sel_plain(sr, si, g8, w, ring)
    for g, p in zip(got, want):
        assert (g - p).abs().max().item() <= TOL
    gr, gi = (torch.as_tensor(c) for c in cot)
    got = emulate_walk(g8, *want, gr, gi, w, ring)
    ref = sel_kernel.sel_chain_bwd_plain(g8, *want, gr, gi, w, ring)
    for g, p in zip(got, ref):
        _assert_rel(g.numpy(), p.numpy())
