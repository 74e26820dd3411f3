"""The adjoint walk of kernels #2 and #4 (``csrc/chain_regs.cuh``) on the
CPU: its launch plan (``gate_kernel.chain_bwd_plan``) at every width and at
the batches the card runs, and a float32 PyTorch emulation of the kernel's
algorithm held against the JAX package's custom VJPs (``jax.vjp`` through
``_gate_chain`` / ``_ry_chain``, whose backwards are the Pallas kernels in
interpret mode).

The emulation follows the kernel step by step: a sample's amplitude index
split into lane, warp and register bits (a thread t of the sample holds the
amplitudes (h << (lane + warp bits)) | t); a gate on a lane or warp bit
formed from the partner thread's values (t ^ 2^bit), each thread computing
only its own new row x of the pair and, with the partner's cotangent, the
two entries of dg that pair both rows' cotangents with that row,
(dg[x][x], dg[1-x][x]), in floats 4x..4x+3 of its 8 (zeros in the
others); a gate on a register bit on the pair inside the thread, all 8
entries in order; each thread's 8 dg partials (2 for an RY encode gate)
written to its row of a strip and summed once a layer down each column
over all rows, in the kernel's order (four running sums over the rows
4i + u, then (s0 + s1) + (s2 + s3)), a lane or warp bit's columns mapped
back to dg's entries; and dg summed over the batch as the launch sums
it: a CTA's samples
in increasing b, the cluster's CTAs in rank order, and, for a batch larger
than one cluster, the clusters in order. Only the float32 roundings of the
fused multiply-adds differ from the card.

Tolerance: 1e-5 relative to max(1, max|JAX|), the kernels' own bar
(``BWD_TOL`` in ``chip_smoke.py``): with N(0, 1) cotangents dg sums
products over all d rows and the batch.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel, ry_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
# (wires, batch, L*k, k)
SHAPES = [(1, 1, 4, 2), (4, 16, 28, 2), (6, 10, 28, 2), (8, 10, 12, 2),
          (10, 3, 4, 2)]
# the batches chip_smoke.py and the card tests run, and each width's edges
# of one sample a CTA and of one cluster
BATCHES = [1, 10, 11, 16, 80]


def _capacity(wires: int) -> int:
    """The largest batch whose dg one cluster sums in the launch."""
    return 32 if wires < 8 else 16


# --- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("wires", range(1, 11))
@pytest.mark.parametrize("edge", ["listed", "cta", "cluster"])
def test_plan_covers_the_batch_and_sums_in_the_launch_when_it_fits(wires,
                                                                   edge):
    if edge == "listed":
        batches = BATCHES
    elif edge == "cta":
        batches = [7, 8, 9]
    else:
        cap = _capacity(wires)
        batches = [cap - 1, cap, cap + 1]
    for batch in batches:
        plan = gate_kernel.chain_bwd_plan(wires, batch)
        warps = 1 if wires < 8 else 2 if wires == 8 else 4
        assert plan.warps == warps
        assert 1 <= plan.samples <= (4 if wires < 8 else 2)
        assert plan.cluster in (1, 2, 4, 8)
        per_cluster = plan.samples * plan.cluster
        assert plan.clusters == -(-batch // per_cluster)
        assert plan.grid == plan.cluster * plan.clusters
        assert plan.threads == 32 * warps * plan.samples
        assert plan.in_launch == (plan.clusters == 1)
        assert plan.in_launch == (batch <= _capacity(wires)), batch
        if plan.in_launch:
            # as few samples a CTA as spread the batch over the cluster
            assert plan.samples == -(-batch // plan.cluster)
            assert plan.cluster == min(8, 1 << (batch - 1).bit_length())
        else:  # one sample a CTA, full clusters
            assert (plan.samples, plan.cluster) == (1, 8)


def test_plan_at_the_models_shapes():
    plan = gate_kernel.chain_bwd_plan
    # QIDDM_LL_noise's training step and sampling batch, QIDDM_PL_noise1's
    # step, the JAX package's A/B shape: one launch, 8 CTAs of 2 samples
    for wires, batch in ((6, 10), (6, 16), (8, 10), (6, 11)):
        p = plan(wires, batch)
        assert (p.samples, p.cluster, p.clusters, p.in_launch) == (
            2, 8, 1, True)
    # QIDDM-A's 80 rows at 10 wires: 80 CTAs of 4 warps, 10 clusters
    p = plan(10, 80)
    assert (p.warps, p.samples, p.grid, p.clusters, p.in_launch) == (
        4, 1, 80, 10, False)


@pytest.mark.parametrize("wires,batch", [(0, 1), (11, 1), (6, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(wires, batch):
    with pytest.raises(ValueError, match="no backward plan"):
        gate_kernel.chain_bwd_plan(wires, batch)


# --- the kernel's algorithm, emulated ----------------------------------------

class _Layout:
    """The kernel's split of a sample's index at ``wires`` wires."""

    def __init__(self, wires: int, batch: int):
        plan = gate_kernel.chain_bwd_plan(wires, batch)
        self.plan = plan
        self.d = 2**wires
        self.lb = min(wires, 5)
        self.wb = plan.warps.bit_length() - 1
        self.a = 2 ** (wires - self.lb - self.wb)
        self.t = 32 * plan.warps
        self.rows = min(self.d, self.t)
        # index[t, h] of thread t's amplitude h; threads t >= d hold none
        t = torch.arange(self.t)[:, None]
        h = torch.arange(self.a)[None, :]
        self.index = (h << (self.lb + self.wb)) | t
        self.holds = (t < self.d).expand(self.t, self.a)

    def load(self, plane):
        """(d, B) plane -> (B, T, A) registers, zeros where none is held."""
        idx = self.index.clamp(max=self.d - 1)
        vals = plane[idx].permute(2, 0, 1)
        return torch.where(self.holds, vals, torch.zeros_like(vals))

    def store(self, regs):
        """(B, T, A) registers -> (d, B) plane."""
        out = regs.new_zeros((self.d, regs.shape[0]))
        out[self.index[self.holds]] = regs[:, self.holds].T
        return out


def _cmul_add(ar, ai, xr, xi, br, bi, yr, yi):
    """a x + b y, complex, in the kernel's term order."""
    return (ar * xr - ai * xi + br * yr - bi * yi,
            ar * xi + ai * xr + br * yi + bi * yr)


def _gate_step(lay, st, m, bit):
    """One adjoint gate on index bit ``bit``: updates st = [sr, si, cr, ci]
    (each (B, T, A)) and returns the threads' 8 dg partials (B, T, 8): in
    order on a register bit, else (dg[x][x], dg[1-x][x]) in floats
    4x..4x+3 and zeros in the others."""
    sr, si, cr, ci = st
    a00r, a00i, a10r, a10i = m[0], -m[1], m[2], -m[3]
    a01r, a01i, a11r, a11i = m[4], -m[5], m[6], -m[7]
    B, T, A = sr.shape
    p = [sr.new_zeros((B, T)) for _ in range(8)]
    if bit >= lay.lb + lay.wb:  # a register bit: pairs in the thread
        rb = 1 << (bit - lay.lb - lay.wb)
        sr, si, cr, ci = (v.clone() for v in (sr, si, cr, ci))
        for h in range(A):
            if h & rb:
                continue
            h1 = h | rb
            s0r, s0i, s1r, s1i = sr[..., h], si[..., h], sr[..., h1], si[..., h1]
            c0r, c0i, c1r, c1i = cr[..., h], ci[..., h], cr[..., h1], ci[..., h1]
            t0r, t0i = _cmul_add(a00r, a00i, s0r, s0i, a01r, a01i, s1r, s1i)
            t1r, t1i = _cmul_add(a10r, a10i, s0r, s0i, a11r, a11i, s1r, s1i)
            p[0] = p[0] + (c0r * t0r + c0i * t0i)
            p[1] = p[1] + (c0i * t0r - c0r * t0i)
            p[2] = p[2] + (c0r * t1r + c0i * t1i)
            p[3] = p[3] + (c0i * t1r - c0r * t1i)
            p[4] = p[4] + (c1r * t0r + c1i * t0i)
            p[5] = p[5] + (c1i * t0r - c1r * t0i)
            p[6] = p[6] + (c1r * t1r + c1i * t1i)
            p[7] = p[7] + (c1i * t1r - c1r * t1i)
            n0 = _cmul_add(a00r, a00i, c0r, c0i, a01r, a01i, c1r, c1i)
            n1 = _cmul_add(a10r, a10i, c0r, c0i, a11r, a11i, c1r, c1i)
            sr[..., h], si[..., h], sr[..., h1], si[..., h1] = t0r, t0i, t1r, t1i
            cr[..., h], ci[..., h] = n0
            cr[..., h1], ci[..., h1] = n1
        return [sr, si, cr, ci], torch.stack(p, -1)
    # a lane or warp bit: the partner thread t ^ 2^bit holds the other row
    t = torch.arange(T)
    partner = t ^ (1 << bit)
    osr, osi, ocr, oci = (v[:, partner] for v in (sr, si, cr, ci))
    x = ((t >> bit) & 1).bool()[None, :, None]
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


def _encode_step(lay, st, c, s, bit):
    """One adjoint encode RY(-x) with per-sample (c, s), each (B,), on index
    bit ``bit``: updates st and returns the threads' (dc, ds) (B, T, 2)."""
    sr, si, cr, ci = st
    B, T, A = sr.shape
    c = c[:, None]
    s = s[:, None]
    dc = sr.new_zeros((B, T))
    ds = sr.new_zeros((B, T))
    if bit >= lay.lb + lay.wb:
        rb = 1 << (bit - lay.lb - lay.wb)
        sr, si, cr, ci = (v.clone() for v in (sr, si, cr, ci))
        for h in range(A):
            if h & rb:
                continue
            h1 = h | rb
            t0r, t0i = c * sr[..., h] + s * sr[..., h1], c * si[..., h] + s * si[..., h1]
            t1r, t1i = c * sr[..., h1] - s * sr[..., h], c * si[..., h1] - s * si[..., h]
            dc = dc + ((cr[..., h] * t0r + ci[..., h] * t0i)
                       + (cr[..., h1] * t1r + ci[..., h1] * t1i))
            ds = ds + ((cr[..., h1] * t0r + ci[..., h1] * t0i)
                       - (cr[..., h] * t1r + ci[..., h] * t1i))
            n0 = (c * cr[..., h] + s * cr[..., h1], c * ci[..., h] + s * ci[..., h1])
            n1 = (c * cr[..., h1] - s * cr[..., h], c * ci[..., h1] - s * ci[..., h])
            sr[..., h], si[..., h], sr[..., h1], si[..., h1] = t0r, t0i, t1r, t1i
            cr[..., h], ci[..., h] = n0
            cr[..., h1], ci[..., h1] = n1
        return [sr, si, cr, ci], torch.stack([dc, ds], -1)
    t = torch.arange(T)
    partner = t ^ (1 << bit)
    osr, osi, ocr, oci = (v[:, partner] for v in (sr, si, cr, ci))
    x = ((t >> bit) & 1).bool()[None, :]
    so = torch.where(x, -s, s)[..., None]
    c3 = c[..., None]
    tr, ti = c3 * sr + so * osr, c3 * si + so * osi  # its own row
    for h in range(A):
        dc = dc + (cr[..., h] * tr[..., h] + ci[..., h] * ti[..., h])
        # the partner's cotangent against this row
        ds = ds - (ocr[..., h] * tr[..., h] + oci[..., h] * ti[..., h])
    ds = torch.where(x, ds, -ds)  # + c1.t0 at x = 0, - c0.t1 at x = 1
    nr, ni = c3 * cr + so * ocr, c3 * ci + so * oci
    return [tr, ti, nr, ni], torch.stack([dc, ds], -1)


def _column_sums(strip, rows: int):
    """(B, T, C) strip -> (B, C): each column over rows 0..rows-1 as the
    kernel's walk_column sums it: four running sums over the rows 4i + u,
    then (s0 + s1) + (s2 + s3)."""
    acc = [strip.new_zeros((strip.shape[0], strip.shape[2]))
           for _ in range(4)]
    for row in range(rows):
        acc[row % 4] = acc[row % 4] + strip[:, row]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _flush(lay, strip, wires: int):
    """(B, T, 8w) strip of a layer -> (B, 8w) dg[l], as walk_flush maps the
    columns: entry e of a lane or warp bit's gate j from column
    8j + 4x + ((e & 1) | (((e >> 2) ^ x) & 1) << 1), x = (e >> 1) & 1."""
    src = []
    for c in range(8 * wires):
        j, e = divmod(c, 8)
        x = (e >> 1) & 1
        if wires - 1 - j < lay.lb + lay.wb:
            c = j * 8 + x * 4 + ((e & 1) | ((((e >> 2) ^ x) & 1) << 1))
        src.append(c)
    return _column_sums(strip[..., src], lay.rows)


def _batch_sum(lay, dgs):
    """(B, n) per-sample dg -> (n,) summed as the launch sums it."""
    plan = lay.plan
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
        first = cl * C * S
        ranks = min(C, -(-(B - first) // S))
        v = parts[cl * C]
        for q in range(1, ranks):
            v = v + parts[cl * C + q]
        sums.append(v)
    if plan.in_launch:
        return sums[0]
    total = torch.zeros_like(sums[0])  # dg_batch_sum_kernel: b increasing
    for v in sums:
        total = total + v
    return total


def emulate_walk(fr, fi, gr, gi, g8, signs, k: int, wires: int, pr=None,
                 pi=None, cs=None):
    """The kernel's walk on (d, B) float32 planes. RZ (pr, pi given):
    returns (dpr, dpi, dg); RY (cs given): (dcs, dg)."""
    d, B = fr.shape
    n_layers = g8.shape[0]
    lay = _Layout(wires, B)
    st = [lay.load(v) for v in (fr, fi, gr, gi)]
    if pr is not None:
        ph = [lay.load(v) for v in (pr, pi)]
        acc = [torch.zeros_like(ph[0]), torch.zeros_like(ph[0])]
    else:
        enc_acc = fr.new_zeros((B, 2 * wires))
    index = lay.index.clamp(max=d - 1)
    dgs = fr.new_zeros((B, n_layers, wires * 8))
    for l in range(n_layers - 1, -1, -1):
        f = signs[l % k][:, 0][index][None]
        st = [v * f for v in st]
        strip = fr.new_zeros((B, lay.t, wires * 8))
        for bit in range(wires):
            j = wires - 1 - bit
            st, part = _gate_step(lay, st, g8[l, j], bit)
            strip[..., j * 8:(j + 1) * 8] = part
        dgs[:, l] = _flush(lay, strip, wires)
        if l % k:
            continue
        if pr is not None:
            sr, si, cr, ci = st
            p_r, p_i = ph
            spr, spi = sr * p_r + si * p_i, si * p_r - sr * p_i
            acc = [acc[0] + (cr * spr + ci * spi),
                   acc[1] + (ci * spr - cr * spi)]
            st = [spr, spi, cr * p_r + ci * p_i, ci * p_r - cr * p_i]
        else:
            strip = fr.new_zeros((B, lay.t, 2 * wires))
            for bit in range(wires):
                j = wires - 1 - bit
                st, part = _encode_step(lay, st, cs[j], cs[wires + j], bit)
                strip[..., 2 * j:2 * j + 2] = part
            enc_acc = enc_acc + _column_sums(strip, lay.rows)
    dg = _batch_sum(lay, dgs.reshape(B, -1)).reshape(n_layers, wires, 8)
    if pr is not None:
        return lay.store(acc[0]), lay.store(acc[1]), dg
    # column 2j carries dc_j, 2j + 1 ds_j; dcs rows j and w + j
    dcs = torch.cat([enc_acc[:, 0::2], enc_acc[:, 1::2]], dim=1).T
    return dcs, dg


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _gates(rng, n_layers, wires):
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32)
    return gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1],
                                         ang[..., 2]))


@pytest.mark.parametrize("w,B,n,k", SHAPES)
def test_emulated_rz_walk_matches_the_pallas_vjp(w, B, n, k):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    rng = np.random.default_rng(w * 100 + B)
    g8 = _gates(rng, n, w)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    pr, pi = torch.cos(x), torch.sin(x)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, w)
    cot = rng.normal(size=(2, 2**w, B)).astype(np.float32)
    gr, gi = (torch.as_tensor(c) for c in cot)
    got = emulate_walk(fr, fi, gr, gi, g8, signs, k, w, pr=pr, pi=pi)
    jsigns = jnp.asarray(signs.numpy())
    _, vjp = jax.vjp(
        lambda a, b, c: jpgk._gate_chain(a, b, c, jsigns, k, w, True),
        jnp.asarray(pr.numpy()), jnp.asarray(pi.numpy()),
        jnp.asarray(g8.numpy()))
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _assert_rel(g.numpy(), w_)


@pytest.mark.parametrize("w,B,n,k", SHAPES)
def test_emulated_ry_walk_matches_the_pallas_vjp(w, B, n, k):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    rng = np.random.default_rng(w * 100 + B + 7)
    g8 = _gates(rng, n, w)
    cs = ry_kernel.ry_cs(torch.as_tensor(2 * rng.normal(size=(B, w)),
                                         dtype=torch.float32))
    signs = gate_kernel._sign_planes_on(k, w, cs.device)
    fr, fi = ry_kernel._ry_plain(cs, g8, signs, k, w)
    cot = rng.normal(size=(2, 2**w, B)).astype(np.float32)
    gr, gi = (torch.as_tensor(c) for c in cot)
    got = emulate_walk(fr, fi, gr, gi, g8, signs, k, w, cs=cs)
    jsigns = jnp.asarray(signs.numpy())
    _, vjp = jax.vjp(lambda a, b: jpgk._ry_chain(a, b, jsigns, k, w, True),
                     jnp.asarray(cs.numpy()), jnp.asarray(g8.numpy()))
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _assert_rel(g.numpy(), w_)


@pytest.mark.parametrize("w,B", [(3, 40), (8, 17), (10, 20)])
def test_emulated_walk_over_several_clusters_matches_plain(w, B):
    """Batches past one cluster (a second launch sums the clusters' dg),
    against the plain walk: the emulation's sum order across CTAs and
    clusters gives the plain sums within the bar."""
    rng = np.random.default_rng(w + B)
    k, n = 2, 4
    assert not gate_kernel.chain_bwd_plan(w, B).in_launch
    g8 = _gates(rng, n, w)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    pr, pi = torch.cos(x), torch.sin(x)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, w)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**w, B)),
                              dtype=torch.float32) for _ in range(2))
    got = emulate_walk(fr, fi, gr, gi, g8, signs, k, w, pr=pr, pi=pi)
    want = gate_kernel.gate_chain_bwd_plain(pr, pi, g8, signs, fr, fi, gr,
                                            gi, k, w)
    for g, w_ in zip(got, want):
        _assert_rel(g.numpy(), w_.numpy())
