"""Numpy models of the tensor-core arithmetic of K1 (`csrc/intra_pred.cu`)
and K5 (`csrc/me_ssd.cu`) and of K3's lanes (`csrc/tu_bits.cu`), lane by
lane as the kernels form them, held against the port's plain PyTorch
versions on the CPU.  The kernels themselves run only on the card
(`tests/test_torch_cuda_kernels.py`);
these check what the card tests cannot show, the fragment arithmetic and
the exactness arguments that the kernels rest on, with plain numpy and no
JAX:

- K5: the Toeplitz correlation as mma.sync m16n8k16 / m16n8k32 8-bit
  products (a warp per 8 offsets dy, fragments of the window rows built
  from aligned words with funnel shifts, the fragments decoded with the
  PTX layouts), the byte split v = 256 h + l of the half-pel plane (the
  h product first, scaled by 256, then the l product added), the
  box sums of the window energies, c2 - 2 corr + w2 modulo 2^32 ->
  `me_ssd_grid_plain`, on 8-bit planes and on K8's half-pel plane of
  0 / 255 steps.
- K1: the two-stage f16 Hadamard (blockdiag(H, H) [D_a; D_b], then H^T),
  every operand rounded to f16 and checked exact, with the 64 hi + lo
  split of stage 1 at bit depth 10 -> `_hadamard8_sum`, and the ranges
  that make each stage exact at bit depth 8 and 10.
- K3 (`csrc/tu_bits.cu`): the lane mapping (8-byte row pieces to 4x4
  groups, one or two groups a lane), the counts from bit masks and
  popcounts, the lanes' sums and maxima and the pricing in f32 ->
  `tu_bits_plain`, at n = 8, 16 and 32 on the I, P and B tables: all-zero
  TUs, a lone DC level, groups with more than 8 nonzero levels,
  remainders past the escape and levels of +-32767.
"""

import numpy as np
import pytest
import torch

from x265amod_tpu_torch.ops import estbits, intra, me

torch.set_num_threads(1)

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


# ---- K5 ---------------------------------------------------------------------

def _words(row_bytes):
    """A byte row as little-endian uint32 words."""
    return row_bytes.astype(np.uint8).view("<u4").astype(np.uint64)


def _funnel_r(lo, hi, sh):
    return ((hi << np.uint64(32)) | lo) >> sh.astype(np.uint64) \
        & np.uint64(0xffffffff)


def _byte(reg, i, signed):
    b = ((reg >> np.uint64(8 * i)) & np.uint64(255)).astype(np.int64)
    return np.where(signed & (b > 127), b - 256, b)


def _mma_i8(a, b, k32, signed_a):
    """D = A . B of one mma.sync (m16n8k16 or m16n8k32, 8-bit operands,
    s32 accumulation): A and B decoded from every lane's registers with
    the PTX fragment layouts; returns D in the lanes' c0..c3 order."""
    kk = 32 if k32 else 16
    A = np.zeros((16, kk), np.int64)
    B = np.zeros((kk, 8), np.int64)
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        for i in range(4):
            A[g, 4 * t + i] = _byte(a[0][ln], i, signed_a)
            A[g + 8, 4 * t + i] = _byte(a[1][ln], i, signed_a)
            B[4 * t + i, g] = _byte(b[0][ln], i, False)
            if k32:
                A[g, 16 + 4 * t + i] = _byte(a[2][ln], i, signed_a)
                A[g + 8, 16 + 4 * t + i] = _byte(a[3][ln], i, signed_a)
                B[16 + 4 * t + i, g] = _byte(b[1][ln], i, False)
    D = A @ B
    return [D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T],
            D[G + 8, 2 * T + 1]]


def k5_model(cur, ref, sr, bn):
    """SSD grid [nb, S, S] as `me_ssd_kernel` forms it."""
    h, w = ref.shape
    s = 2 * sr + 1
    ws = bn + 2 * sr
    mt = (s + 15) // 16
    pitch = (16 * mt + bn + 4 + 15) & ~15
    k32 = bn == 32
    wb = w // bn
    out = np.zeros((cur.shape[0], s, s), np.float32)
    m32 = np.uint64(0xffffffff)
    for b in range(cur.shape[0]):
        bx, by = (b % wb) * bn, (b // wb) * bn
        ys = np.clip(np.arange(by - sr, by - sr + ws), 0, h - 1)
        xs = np.clip(np.arange(bx - sr, bx - sr + ws), 0, w - 1)
        win = np.zeros((ws, pitch), np.int64)
        win[:, :ws] = ref[ys[:, None], xs[None, :]]
        c = cur[b].astype(np.int64)
        assert c.min() >= 0 and c.max() <= 255
        assert win.min() >= -2048 and win.max() <= 2047
        hi = bool(((win < 0) | (win > 255)).any())
        wl, wh = win & 255, (win >> 8) & 255      # h stored as s8 bytes
        cbw = _words(c.reshape(-1)).reshape(bn, bn // 4)
        corr = np.zeros((s, s), np.uint64)
        for warp in range((s + 7) // 8):
            dy0 = 8 * warp
            acc = [[np.zeros(32, np.int64) for _ in range(4)]
                   for _ in range(mt)]
            qb = T + (G >> 2)
            sh8 = (G & 3) * 8
            for plane in range(int(hi), -1, -1):   # the h plane first
                row_bytes = wh if plane else wl
                for r in range(dy0, min(dy0 + 8 + bn - 1, ws)):
                    y = r - dy0 - G
                    inn = (y >= 0) & (y < bn)
                    yc = np.clip(y, 0, bn - 1)
                    bf = [np.where(inn, cbw[yc, T], 0).astype(np.uint64),
                          np.where(inn, cbw[yc, 4 + T], 0).astype(np.uint64)
                          if k32 else None]
                    row = _words(row_bytes[r])
                    nwords = 4 * mt + (4 if k32 else 0)
                    wd = [row[qb + k] for k in range(nwords)]
                    for i in range(mt):
                        a = [_funnel_r(wd[4 * i], wd[4 * i + 1], sh8),
                             _funnel_r(wd[4 * i + 2], wd[4 * i + 3], sh8)]
                        if k32:
                            a += [_funnel_r(wd[4 * i + 4], wd[4 * i + 5],
                                            sh8),
                                  _funnel_r(wd[4 * i + 6], wd[4 * i + 7],
                                            sh8)]
                        d = _mma_i8(a, bf, k32, plane == 1)
                        for j in range(4):
                            acc[i][j] += d[j]
                            assert np.abs(acc[i][j]).max() < 2 ** 31
                if plane:
                    acc = [[256 * v for v in t] for t in acc]
            for i in range(mt):
                for j in range(4):
                    dx = 16 * i + G + (j >> 1) * 8
                    dy = dy0 + 2 * T + (j & 1)
                    ok = (dx < s) & (dy < s)
                    v = acc[i][j].astype(np.uint64) & m32
                    corr[dy[ok], dx[ok]] = v[ok]
        m = 1 << 32                 # every term modulo 2^32, as the kernel
        sq = [[int(v) ** 2 for v in row] for row in win[:, :ws]]
        rs = np.zeros((ws, s), np.int64)
        for r in range(ws):
            acc_ = sum(sq[r][:bn]) % m
            rs[r, 0] = acc_
            for dx in range(1, s):
                acc_ = (acc_ + sq[r][dx + bn - 1] - sq[r][dx - 1]) % m
                rs[r, dx] = acc_
        c2 = int((c ** 2).sum()) % m
        for dx in range(s):
            w2 = int(rs[:bn, dx].sum()) % m
            for dy in range(s):
                if dy:
                    w2 = (w2 + int(rs[dy + bn - 1, dx])
                          - int(rs[dy - 1, dx])) % m
                ssd = (c2 - 2 * int(corr[dy, dx]) + w2) % m
                out[b, dy, dx] = np.float32(ssd - (m if ssd >= m // 2
                                                   else 0))
    return out


def _steps(rng, h, w):
    """An 8-bit plane of 0 / 255 steps with texture between them."""
    p = rng.integers(0, 256, (h, w))
    p[: h // 2, : w // 3] = 0
    p[h // 2:, w // 3: 2 * w // 3] = 255
    p[:, -3:] = 255
    return p.astype(np.int32)


@pytest.mark.parametrize("bn,sr,h,w,half", [
    (16, 1, 32, 48, False), (16, 4, 32, 32, True), (32, 3, 64, 32, False),
    (32, 2, 32, 64, True), (16, 9, 16, 16, True)])
def test_k5_toeplitz_byte_split_model(bn, sr, h, w, half):
    rng = np.random.default_rng(bn * 100 + sr)
    ref = torch.as_tensor(_steps(rng, h, w))
    if half:
        ref = me.hpel_plane_plain(ref)
        assert int(ref.min()) < 0 and int(ref.max()) > 255
    cur = torch.as_tensor(_steps(rng, h, w)).reshape(
        h // bn, bn, w // bn, bn).permute(0, 2, 1, 3).reshape(-1, bn, bn)
    want = me.me_ssd_grid_plain(cur, ref, sr, bn).numpy()
    got = k5_model(cur.numpy(), ref.numpy(), sr, bn)
    assert np.array_equal(got, want)


def test_k5_half_pel_range_of_an_8_bit_plane():
    """K8's plane of 8-bit input lies in [-263, 518] (the 8-tap half-pel
    filter's negative taps, -1 4 -11 40 twice, at 0 / 255 steps): the
    byte split's h in [-2, 2] and 1024 * 255 * 518 < 2^31."""
    taps = me.LUMA_FILTERS[2].astype(np.int64)
    neg = taps.clip(max=0).sum()
    pos = taps.clip(min=0).sum()
    lo = (255 * 2 * pos * neg + 2048) >> 12          # mixed signs
    hi = (255 * (pos * pos + neg * neg) + 2048) >> 12
    assert (lo, hi) == (-263, 518)
    plane = np.zeros((16, 16), np.int32)
    plane[:, 8:] = 255
    plane[8:, :] = 255 - plane[8:, :]
    hp = me.hpel_plane_plain(torch.as_tensor(plane)).numpy()
    assert hp.min() >= -263 and hp.max() <= 518
    assert 1024 * 255 * 518 < 2 ** 31 and -2 <= (-263 >> 8) <= (518 >> 8)


# ---- K1 ---------------------------------------------------------------------

def _f16(x):
    """x rounded to f16, asserted exact."""
    y = np.asarray(x, np.float32).astype(np.float16).astype(np.float32)
    assert np.array_equal(y, np.asarray(x, np.float32))
    return y


H8 = np.array([[(-1) ** bin(i & j).count("1") for j in range(8)]
               for i in range(8)], np.float32)


def hadamard_pair_model(da, db, bd):
    """(SATD_a, SATD_b) of two 8x8 differences as `satd35_kernel` forms
    them: stage 1 A = blockdiag(H, H) and B = [D_a; D_b] from the lanes'
    f16 registers, stage 2 its f32 result as the m16n8k8 A fragment times
    H^T, at bit depth 10 through 64 hi + lo; per block sum |.| over the
    lanes' c0 c1 (block a) and c2 c3 (block b), then (sum + 2) >> 2."""
    A1 = np.zeros((16, 16), np.float32)
    B1 = np.zeros((16, 8), np.float32)
    B2 = np.zeros((8, 8), np.float32)
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        h = _f16([H8[g, 2 * t], H8[g, 2 * t + 1]])
        A1[g, 2 * t:2 * t + 2] = h                 # reg0
        A1[g + 8, 2 * t + 8:2 * t + 10] = h        # reg3 (reg1, reg2 zero)
        B1[2 * t:2 * t + 2, g] = _f16([da[2 * t, g], da[2 * t + 1, g]])
        B1[2 * t + 8:2 * t + 10, g] = _f16([db[2 * t, g], db[2 * t + 1, g]])
        B2[2 * t:2 * t + 2, g] = h
    C1 = A1 @ B1
    assert np.array_equal(C1, np.rint(C1)) and np.abs(C1).max() < 2 ** 24
    if bd == 8:
        R = _f16(C1) @ B2
    else:
        hi = np.floor(C1 * np.float32(0.015625))
        lo = C1 - 64 * hi
        R = 64 * (_f16(hi) @ B2) + _f16(lo) @ B2
    assert np.abs(R).max() < 2 ** 24
    sa = int(np.abs(R[:8]).sum())
    sb = int(np.abs(R[8:]).sum())
    return (sa + 2) >> 2, (sb + 2) >> 2


@pytest.mark.parametrize("bd", [8, 10])
def test_k1_f16_hadamard_model(bd):
    rng = np.random.default_rng(bd)
    maxv = (1 << bd) - 1
    d = rng.integers(-maxv, maxv + 1, (40, 8, 8))
    d[0], d[1] = maxv, -maxv                   # stage 1 at its extremes
    d[2] = np.where(H8 > 0, maxv, -maxv)       # one coefficient at 64 maxv
    d[3] = 0
    want = intra._hadamard8_sum(torch.as_tensor(d.astype(np.int32))).numpy()
    for i in range(0, 40, 2):
        assert hadamard_pair_model(d[i], d[i + 1], bd) == (want[i],
                                                           want[i + 1])


@pytest.mark.parametrize("bd", [8, 10])
def test_k1_f16_stage_ranges(bd):
    """The ranges the f16 Hadamard rests on: |D| <= 2^bd - 1, stage 1 (8
    terms) in f16's exact integers (to 2,048) at bit depth 8; at bit depth
    10 its 64 hi + lo parts each exact in f16 (|hi| <= 128, 0 <= lo < 64),
    so that both stage-2 products and 64 R_hi + R_lo stay below 2^24 in
    f32."""
    maxv = (1 << bd) - 1
    s1 = 8 * maxv
    s2 = 8 * s1
    assert s2 < 2 ** 24
    if bd == 8:
        assert s1 <= 2048
    else:
        assert s1 > 2048
        hi_max = -(-s1 // 64)
        assert hi_max <= 128 and 8 * 64 * hi_max + 8 * 63 < 2 ** 24
        for v in (-s1, -s1 + 1, -1, 0, 1, s1 - 1, s1):
            hi = np.floor(np.float32(v) * np.float32(0.015625))
            lo = np.float32(v) - 64 * hi
            assert 64 * hi + lo == v and abs(hi) <= 128 and 0 <= lo < 64
            assert _f16(hi) == hi and _f16(lo) == lo


# ---- K3 ---------------------------------------------------------------------

def _bitlen(v):
    return int(v).bit_length() if v > 0 else 0


def _popc(m):
    return bin(m).count("1")


def k3_group_count(v, n, g):
    """`tu_bits.cuh:group_count`: the counts of group g (16 levels v in
    raster order inside the group) of a TU of size n, as a dict, from bit
    masks as the kernel forms them: nonzero and beyond-1 masks, the first
    8 nonzero levels as the lowest 8 set bits, popcounts for the flags,
    Golomb-Rice remainders where a level is beyond 1."""
    g4 = n // 4
    gy, gx = divmod(g, g4)
    c = dict.fromkeys(("n_cod", "n1", "n0", "dc_nz", "cg0_cod", "g1_1",
                       "g1_0", "g2", "rem_i", "over8", "nnz", "lx", "ly"),
                      0)
    a = [abs(int(x)) for x in v]
    nz = sum(1 << q for q in range(16) if a[q])
    gt1 = sum(1 << q for q in range(16) if a[q] > 1)
    if not nz:
        return c
    k = min(max(_bitlen(sum(a)) - 5, 0), 4)
    rest = nz
    for _ in range(8):
        rest &= rest - 1
    take = nz ^ rest
    c["g1_1"] = _popc(take & gt1)
    c["g1_0"] = _popc(take) - c["g1_1"]
    c["g2"] = int(c["g1_1"] > 0)
    c["over8"] = _popc(rest) * (1 + k)
    c["n1"] = _popc(nz & ~1 if g == 0 else nz)
    c["n0"] = (15 if g == 0 else 16) - c["n1"]
    for q in range(16):
        rem = a[q] - (3 if (take >> q) & 1 else 1)
        if (gt1 >> q) & 1 and rem > 0:
            pref = rem >> k
            esc = _bitlen(max(rem - (2 << k), 1)) - k
            c["rem_i"] += pref + 1 + k if pref < 3 else 3 + 2 * esc + k
    cols = (nz | nz >> 4 | nz >> 8 | nz >> 12) & 15
    rows = sum(1 << i for i in range(4) if (nz >> (4 * i)) & 15)
    c.update(n_cod=1, nnz=_popc(nz), lx=gx * 4 + cols.bit_length() - 1,
             ly=gy * 4 + rows.bit_length() - 1)
    if g == 0:
        c.update(cg0_cod=1, dc_nz=nz & 1)
    return c


def k3_total_bits(c, n, row):
    """`tu_bits.cuh:total_bits` in f32, the families in integer units of
    2^-15 bit."""
    f = np.float32
    if c["nnz"] == 0:
        return row[0]
    ncg = (n // 4) ** 2
    u = [int(np.rint(f(x) * f(32768))) for x in row]
    csb_u = u[3] * c["n_cod"] + u[2] * (ncg - c["n_cod"]) - u[3]
    sig_u = (c["n1"] * u[7] + c["n0"] * u[6]
             + ((u[5] if c["dc_nz"] else u[4]) if c["cg0_cod"] else 0))
    g1_u = c["g1_1"] * u[9] + c["g1_0"] * u[8]
    g2_u = c["g2"] * u[10]
    sc = f(1.0 / 32768.0)
    csb = max(f(f(csb_u) * sc) + f(0.0), f(0.0))
    lp = estbits.group_idx_bins(32)
    total = f(row[1]) + f(f(lp[c["lx"]] + lp[c["ly"]]) * f(row[11]))
    for term in (csb, f(sig_u) * sc, f(g1_u) * sc, f(g2_u) * sc,
                 f(c["rem_i"]), f(c["over8"]), f(c["nnz"])):
        total = f(total + f(term))
    return total


def k3_model(levels, n, qp, table):
    """K3 (`csrc/tu_bits.cu:tu_bits_lanes`) lane by lane: n 8 a lane a
    4x4 group (4 lanes a TU), 16 and 32 two groups a lane (8 lanes, group
    rows gy and gy + 2; 32 lanes, gy and gy + 4), each group read as four
    8-byte row pieces (two little-endian
    words, unpacked to four int16 levels), the lane's counts combined,
    summed and maxed over the TU's lanes, priced by its first lane.  Also
    checks that the pieces tile the TU, each byte read once, and that the
    lanes of one group row read one contiguous run."""
    g4, ng = n // 4, (n // 4) ** 2
    lanes = 4 if n == 8 else ng // 2
    out = np.zeros(len(levels), np.float32)
    for t, tu in enumerate(levels):
        raw = np.ascontiguousarray(tu, np.int16).view(np.uint8).ravel()
        seen = np.zeros(raw.size, int)
        runs = {}
        per_lane = []
        for ln in range(lanes):
            cs = []
            for g in range(ln, ng, lanes):
                gy, gx = divmod(g, g4)
                v = []
                for i in range(4):
                    off = 2 * ((4 * gy + i) * n + 4 * gx)
                    assert off % 8 == 0
                    seen[off:off + 8] += 1
                    runs.setdefault((gy, i), []).append(off)
                    w = raw[off:off + 8].view("<u4")
                    for word in w:
                        lo, hi = int(word) & 0xffff, int(word) >> 16
                        v += [lo - 65536 if lo > 32767 else lo,
                              hi - 65536 if hi > 32767 else hi]
                cs.append(k3_group_count(v, n, g))
            per_lane.append({k: (max if k in ("lx", "ly", "cg0_cod", "dc_nz")
                                 else sum)(c[k] for c in cs)
                             for k in cs[0]})
        assert np.all(seen == 1)
        for offs in runs.values():
            offs = sorted(offs)
            assert offs == list(range(offs[0], offs[0] + 8 * len(offs), 8))
        tot = {k: (max if k in ("lx", "ly", "cg0_cod", "dc_nz") else sum)(
            c[k] for c in per_lane) for k in per_lane[0]}
        out[t] = k3_total_bits(tot, n, table[min(max(int(qp[t]), 0), 51)])
    return out


def _k3_levels(rng, n, kind):
    t = 6
    lv = np.zeros((t, n, n), np.int64)
    if kind == "dc":
        lv[:, 0, 0] = rng.integers(-5, 6, t) | 1
    elif kind == "over8":                  # more than 8 nonzeros a group
        lv[:, :4, :4] = rng.integers(1, 4, (t, 4, 4)) * rng.choice([-1, 1],
                                                                   (t, 4, 4))
        lv[:, n - 4:, n - 4:] = rng.integers(-2, 3, (t, 4, 4))
    elif kind == "escape":                 # remainders past the escape
        lv[:] = rng.integers(-40, 41, (t, n, n)) * (rng.random((t, n, n))
                                                    < 0.4)
        lv[:, 1, 1] = rng.choice([300, -2000, 9000], t)
    elif kind == "extremes":
        lv[:] = rng.choice([32767, -32767, 0, 1], (t, n, n))
        lv[0] = 32767
        lv[1] = -32767
    return lv.astype(np.int16)


def test_k3_lane_model():
    """One case for every size, kind and table (kept to one test: this
    file stays among the short ones that the parallel run hands out after
    its longest file)."""
    for n in (8, 16, 32):
        for kind in ("zeros", "dc", "over8", "escape", "extremes"):
            rng = np.random.default_rng(n * 7 + len(kind))
            lv = _k3_levels(rng, n, kind)
            qp = rng.choice([0, 22, 32, 51, 60], len(lv)).astype(np.int32)
            for st in ("I", "P", "B"):
                table = estbits.bit_consts_table(st, 0)
                want = estbits.tu_bits_plain(torch.as_tensor(lv), 0,
                                             torch.as_tensor(qp), st).numpy()
                got = k3_model(lv, n, qp, table)
                assert np.array_equal(got.view(np.uint32),
                                      want.view(np.uint32)), (n, kind, st)
