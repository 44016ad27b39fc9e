"""The schedule of K23, the flat CTB16 scan on the card, checked on the CPU
with plain PyTorch only: its ticket list (`ops.commit.scan_tickets`, the
plain version of the kernel's first launch, which the card tests hold the
kernel's list to) and the plain scan run one ticket at a time in that
order.

- For all-intra frames and for the kinds maps a flat P/B commit meets (all
  intra, no intra, one intra column, one intra diagonal chain, a
  checkerboard, random), every coded CTU holds exactly one ticket, the
  tickets follow the anti-diagonals d = cx + 2 cy, and each coded CTU's
  coded neighbours (left, top-left, top, top-right: the ones it reads and
  waits on) hold smaller tickets.
- `IntraFrameEncoder._scan_plain` run one ticket at a time (its
  diagonal steps swapped for single-CTU steps in ticket order) equals the
  same scan run diagonal by diagonal, exactly: all-intra (a batch of two
  frames), lossless, and the commit of a flat P frame on random kinds with
  random inter recon and levels in place.

And the schedule of K24, K25 and K19, the decide scans on the card that
walk the grid a thread a CTU row: the walk visits each diagonal's CTUs at
that diagonal's step, and every CTU's neighbours commit one to three steps
before it, as the row's register window holds them; step-by-step models
of the walks equal the plain scans, free and forced: `k24_row_walk`
(`decide_p_plain`), `k25_row_walk` (`decide_b_plain`), `k19_row_walk`
(`BTreeEncoder._decide_b_plain`, with the read set K19 copies as a step
starts: every grid entry a decision prices is in it) and `k17_row_walk`
(`InterTreeEncoder._decide_plain` at R 1, 2 and 4, with the 36 entries
K17 copies as a step starts); and every inter CTU's final MV is its
mrg0, mrg1 or ME MV.
"""

import numpy as np
import pytest
import torch

from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
from x265amod_tpu_torch.ops.commit import scan_tickets

torch.set_num_threads(1)


def _kinds(name, f, hc, wc, rng):
    """A kinds map [F, hc, wc] (2 = intra, 0 skip, 1 inter) or None."""
    if name == "all-intra-frame":
        return None
    k = rng.integers(0, 2, (f, hc, wc))
    yy, xx = np.mgrid[0:hc, 0:wc]
    if name == "all":
        k[:] = 2
    elif name == "none":
        pass
    elif name == "column":
        k[:, :, wc // 2] = 2
    elif name == "diagonal":              # each CTU the top-right of the next
        k[:, (xx + yy) == wc - 1] = 2
    elif name == "checker":
        k[:, (xx + yy) % 2 == 0] = 2
    else:
        k[rng.random((f, hc, wc)) < float(name)] = 2
    return k


@pytest.mark.parametrize("name", [
    "all-intra-frame", "all", "none", "column", "diagonal", "checker",
    "0.05", "0.3", "0.7"])
@pytest.mark.parametrize("f,wc,hc", [(1, 7, 5), (3, 4, 6), (2, 9, 3),
                                     (1, 120, 68)])
def test_tickets_follow_the_dependencies(name, f, wc, hc):
    rng = np.random.default_rng(hc * 100 + wc)
    kinds = _kinds(name, f, hc, wc, rng)
    tickets = scan_tickets(kinds, f, wc, hc)
    coded = (np.ones((f, hc, wc), bool) if kinds is None else kinds == 2)
    assert sorted(tickets) == list(np.flatnonzero(coded))
    order = np.full((f, hc, wc), -1)
    for t, i in enumerate(tickets):
        order.flat[i] = t
    fi, cy, cx = np.unravel_index(np.asarray(tickets, int), (f, hc, wc))
    key = (cx + 2 * cy) * f * hc + fi * hc + cy     # diagonal, frame, row
    assert np.all(np.diff(key) > 0)
    for t, (a, y, x) in enumerate(zip(fi, cy, cx)):
        for ny, nx in ((y, x - 1), (y - 1, x - 1), (y - 1, x),
                       (y - 1, x + 1)):
            if 0 <= ny < hc and 0 <= nx < wc and coded[a, ny, nx]:
                assert order[a, ny, nx] < t, (t, a, y, x, ny, nx)


def _planes(rng, f, w, h):
    return [torch.as_tensor(rng.integers(0, 256, s).astype(np.int32))
            for s in ((f, h, w), (f, h // 2, w // 2), (f, h // 2, w // 2))]


def _in_ticket_order(enc, kinds=None):
    """``enc`` with its scan's steps (`_diag_lanes`) replaced by one CTU a
    step in K23's ticket order."""
    hc, wc = enc.hc, enc.wc
    k = None if kinds is None else kinds.numpy()

    def lanes(f):
        steps = []
        for t in scan_tickets(k, f, wc, hc):
            fi, rest = divmod(t, hc * wc)
            steps.append(tuple(torch.tensor([v])
                               for v in (fi, rest % wc, rest // wc)))
        return steps
    enc._diag_lanes = lanes
    return enc


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("lossless", [False, True])
def test_plain_scan_in_ticket_order_all_intra(lossless):
    rng = np.random.default_rng(3)
    w, h, f = 96, 48, 2
    enc = IntraFrameEncoder(w, h, lossless=lossless, device="cpu")
    y, cb, cr = _planes(rng, f, w, h)
    y[1, 16:32] = 255                                 # a flat band
    maps = enc._maps(27)
    want = enc._scan_plain(y, cb, cr, maps)
    _same(want, _in_ticket_order(enc)._scan_plain(y, cb, cr, maps))


@pytest.mark.parametrize("name", ["column", "diagonal", "checker", "0.4"])
def test_plain_scan_in_ticket_order_p_commit(name):
    rng = np.random.default_rng(11)
    w, h = 112, 64
    enc = IntraFrameEncoder(w, h, device="cpu")
    hc, wc = h // 16, w // 16
    y, cb, cr = _planes(rng, 1, w, h)
    kinds = torch.as_tensor(_kinds(name, 1, hc, wc, rng).astype(np.int32))
    rec = _planes(rng, 1, w, h)
    lv = (torch.as_tensor(rng.integers(-9, 10, (1, hc, wc, 16, 16)),
                          dtype=torch.int16),
          torch.as_tensor(rng.integers(-9, 10, (1, hc, wc, 8, 8)),
                          dtype=torch.int16),
          torch.as_tensor(rng.integers(-9, 10, (1, hc, wc, 8, 8)),
                          dtype=torch.int16))
    maps = enc._maps(32)
    inter = (kinds, rec, lv, "P")
    want = enc._scan_plain(y, cb, cr, maps, inter)
    _same(want, _in_ticket_order(enc, kinds)._scan_plain(y, cb, cr, maps,
                                                          inter))


# ---- K24: the flat P decide scan, a thread a CTU row ------------------------

_GRIDS = [(120, 68), (80, 45), (7, 5), (1, 9), (9, 1)]


@pytest.mark.parametrize("wc,hc", _GRIDS)
def test_row_walk_visits_the_diagonals(wc, hc):
    """K24's walk: thread r decides CTU (t - 2 r, r) at step t.  Step t
    holds exactly diagonal t's CTUs, every CTU once, and each CTU's
    neighbours in the frame commit before it: A1 (its own row) and B0 at
    step t - 1, B1 at t - 2, B2 at t - 3, the three of the row above being
    the entries of the register window that row's slot feeds."""
    from x265amod_tpu_torch.models.intra_frame import _diag_schedule
    diags = {cx + 2 * cy: sorted(c) for c in _diag_schedule(wc, hc)
             for cx, cy in c[:1]}
    steps = wc + 2 * (hc - 1)
    step_of = {}
    for t in range(-1, steps + 1):
        cells = sorted((t - 2 * r, r) for r in range(hc)
                       if 0 <= t - 2 * r < wc)
        assert cells == diags.get(t, [])
        for c in cells:
            assert c not in step_of
            step_of[c] = t
    assert len(step_of) == wc * hc
    for (x, y), t in step_of.items():
        for (dx, dy), lag in (((-1, 0), 1), ((1, -1), 1), ((0, -1), 2),
                              ((-1, -1), 3)):
            if 0 <= x + dx < wc and 0 <= y + dy < hc:
                assert step_of[(x + dx, y + dy)] == t - lag


def _p_inputs(rng, wc, hc, sr, far=0.1):
    """Random flat P decide inputs with many repeated MVs (so the merge
    pruning bites), some beyond the +-sr window (1e18 lookups) and costs
    that let every choice win somewhere."""
    n, s = wc * hc, 2 * sr + 1
    mv = rng.integers(-2, 3, (n, 2)) * 4 + rng.integers(0, 2, (n, 2)) * 2
    big = rng.random(n) < far
    mv[big] = rng.integers(-8 * sr, 8 * sr + 1, (int(big.sum()), 2))
    grid = rng.uniform(0, 3000, (n, s, s)).astype(np.float32)
    d = rng.uniform(0, 3000, n).astype(np.float32)
    rb = rng.uniform(0, 60, n).astype(np.float32)
    di = rng.uniform(500, 4000, n).astype(np.float32)
    lam = rng.uniform(2, 40, n).astype(np.float32)
    return [torch.as_tensor(a) for a in (grid, d, rb, di,
                                          mv.astype(np.int32), lam)]


def _merge_of(wc, hc, inter, mv, x, y):
    """mrg0, mrg1 of CTU (x, y) from the committed maps (the spec's merge
    list as JAX `decide_body` builds it: A1, B1, B0, B2; B1 pruned against
    A1, B0 against B1, B2 against A1 and B1; zero fill)."""
    def nb(dx, dy):
        px, py = x + dx, y + dy
        if 0 <= px < wc and 0 <= py < hc and inter[py, px]:
            return True, tuple(mv[py, px])
        return False, (0, 0)
    c = [nb(-1, 0), nb(0, -1), nb(1, -1), nb(-1, -1)]
    same = [c[1][0] and c[0][0] and c[1][1] == c[0][1],
            c[2][0] and c[1][0] and c[2][1] == c[1][1],
            c[3][0] and ((c[0][0] and c[3][1] == c[0][1])
                         or (c[1][0] and c[3][1] == c[1][1]))]
    keep = [c[0][0], c[1][0] and not same[0], c[2][0] and not same[1],
            c[3][0] and not same[2]]
    got = [c[i][1] for i in range(4) if keep[i]] + [(0, 0), (0, 0)]
    return got[0], got[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_final_mv_is_mrg0_mrg1_or_me(seed):
    """What a speculative K24 (grid entries read a step ahead, at every MV
    a neighbour may end on) rests on: in `decide_p_plain`'s outputs on
    random 128x96 inputs, every inter CTU's final MV is its mrg0 (choice
    0), its mrg1 (choice 1) or its ME MV (choice 2)."""
    from x265amod_tpu_torch.ops.decide_flat import Schedule, decide_p_plain
    rng = np.random.default_rng(seed)
    wc, hc, sr = 8, 6, 4
    grid, d, rb, di, me, lam = _p_inputs(rng, wc, hc, sr)
    out = decide_p_plain(Schedule(wc, hc, "cpu"), grid, d, rb, di, me, lam,
                         sr, 9.5)
    ch = out["choice"].numpy().reshape(hc, wc)
    mv = out["mv"].numpy().reshape(hc, wc, 2)
    assert len(set(ch.ravel().tolist())) == 4
    inter = ch <= 2
    for y in range(hc):
        for x in range(wc):
            m0, m1 = _merge_of(wc, hc, inter, mv, x, y)
            want = {0: m0, 1: m1, 2: tuple(me.numpy()[y * wc + x]),
                    3: tuple(me.numpy()[y * wc + x])}[int(ch[y, x])]
            assert tuple(mv[y, x]) == want, (x, y, ch[y, x])


def k24_row_walk(wc, hc, grid, d, rb, di, me, lam, sr, hdr, forced=None):
    """K24 (`csrc/decide_flat.cu:decide_rows_p`) step by step as the card
    runs it: each row's register window of the row above's commits (B0,
    B1, B2 of steps t - 1, t - 2, t - 3, fed from a slot after the step's
    barrier), its own previous commit (A1), its inputs loaded a step
    ahead, the grid entries at the inter neighbours' MVs and at the zero MV
    read as the step starts, the merge pruning picking two of them.
    Returns the raster outputs of `decide_p_plain`."""
    from x265amod_tpu_torch.ops.me import mvd_bits
    from x265amod_tpu_torch.ops.rdoq import fma32
    n = wc * hc

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    def lookup(ctu, mx, my):
        ix, iy = mx >> 2, my >> 2
        if abs(ix) > sr or abs(iy) > sr:
            return f32(1e18)
        return grid[ctu, iy + sr, ix + sr]

    none = (0, 0, 0)                          # inter, x, y
    A = [none] * hc
    U = [[none] * 3 for _ in range(hc)]       # B0, B1, B2
    cur = [None] * hc                         # the CTU whose inputs are in
    out = dict(choice=torch.zeros(n, dtype=torch.int64),
               mv=torch.zeros((n, 2), dtype=torch.int32),
               mvd=torch.zeros((n, 2), dtype=torch.int32),
               mvp=torch.zeros(n, dtype=torch.int32),
               js=torch.zeros((n, 4)))
    for t in range(-1, wc + 2 * (hc - 1)):
        nxt, mine = [None] * hc, [none] * hc
        for r in range(hc):                      # up to the barrier
            x = t - 2 * r
            ctu = r * wc + x
            if 0 <= x + 1 < wc:
                nxt[r] = ctu + 1
            if not 0 <= x < wc:
                continue
            assert cur[r] == ctu
            c = [A[r], U[r][1], U[r][0], U[r][2]]   # A1, B1, B0, B2
            av = [e[0] == 1 for e in c]
            mvs = [tuple(e[1:]) for e in c]
            if forced is None:
                gv = [lookup(ctu, *m) if v else None
                      for v, m in zip(av, mvs)]
                gz = lookup(ctu, 0, 0)
            else:
                gv, gz = [None] * 4, None
            keep = [av[0], av[1] and not (av[0] and mvs[1] == mvs[0]),
                    av[2] and not (av[1] and mvs[2] == mvs[1]),
                    av[3] and not (av[0] and mvs[3] == mvs[0])
                    and not (av[1] and mvs[3] == mvs[1])]
            mrg = [(mvs[i], gv[i]) for i in range(4) if keep[i]]
            mrg = (mrg + [((0, 0), gz)] * 2)[:2]
            a1, bb = av[0], av[1] or av[2] or av[3]
            b = mvs[2] if av[2] else (mvs[1] if av[1] else mvs[3])
            bb2 = bb and not (a1 and b == mvs[0])
            p0 = mvs[0] if a1 else (b if bb2 else (0, 0))
            p1 = b if a1 and bb2 else (0, 0)
            if forced is None:
                mex, mey = (int(v) for v in me[ctu])
                cand = torch.tensor([[mex - p0[0], mey - p0[1]],
                                     [mex - p1[0], mey - p1[1]]])
                bits = mvd_bits(cand)
                mvp = int(bits[1] < bits[0])
                mvd = tuple(cand[mvp].tolist())
                js = torch.stack([
                    fma32(lam[ctu], f32(2.0), mrg[0][1]),
                    fma32(lam[ctu], f32(3.0), mrg[1][1]),
                    fma32(lam[ctu], (rb[ctu] + bits.min()) + 6.0, d[ctu]),
                    fma32(lam[ctu], f32(hdr), di[ctu])])
                ch = int(torch.argmin(js))
                out["js"][ctu] = js
            else:
                ch, mvp = int(forced[0][ctu]), int(forced[2][ctu])
                mvd = tuple(int(v) for v in forced[1][ctu])
                p = p1 if mvp == 1 else p0
                mex, mey = p[0] + mvd[0], p[1] + mvd[1]
            v = mrg[ch][0] if ch <= 1 else (mex, mey)
            out["choice"][ctu], out["mvp"][ctu] = ch, mvp
            out["mv"][ctu] = torch.tensor(v)
            out["mvd"][ctu] = torch.tensor(mvd)
            mine[r] = (1, v[0], v[1]) if ch <= 2 else none
        for r in range(hc):                      # after it
            U[r] = [mine[r - 1] if r else none, U[r][0], U[r][1]]
            A[r] = mine[r]
        cur = nxt
    if forced is not None:
        del out["js"]
    return out


@pytest.mark.parametrize("wc,hc,seed", [(8, 6, 0), (8, 6, 1), (7, 5, 2),
                                        (1, 9, 3), (9, 1, 4), (3, 4, 5)])
def test_k24_row_walk_model_equals_the_plain_scan(wc, hc, seed):
    """The row walk (`k24_row_walk`) equals `decide_p_plain` exactly, free
    (choices, MVs, MVDs, MVP indices, cost rows) and forced with the plain
    scan's decisions."""
    from x265amod_tpu_torch.ops.decide_flat import Schedule, decide_p_plain
    rng = np.random.default_rng(seed)
    sr, hdr = 4, 9.5
    grid, d, rb, di, me, lam = _p_inputs(rng, wc, hc, sr)
    sch = Schedule(wc, hc, "cpu")
    want = decide_p_plain(sch, grid, d, rb, di, me, lam, sr, hdr,
                          want_costs=True)
    got = k24_row_walk(wc, hc, grid, d, rb, di, me, lam, sr, hdr)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    forced = (want["choice"], want["mvd"], want["mvp"])
    want_f = decide_p_plain(sch, None, None, None, None, None, lam, sr, hdr,
                            forced=forced)
    got_f = k24_row_walk(wc, hc, None, None, None, None, None, lam, sr, hdr,
                         forced=forced)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k].to(got_f[k].dtype)), k
        assert torch.equal(got_f[k], want[k].to(got_f[k].dtype)), k


# ---- K25 and K19: the B decide scans, a thread a CTU row --------------------

def _bits(x, y):
    """MVD bins of (x, y) in qpel: 2 (bitlen |x| + bitlen |y|) + 2."""
    return float(2 * (abs(x).bit_length() + abs(y).bit_length()) + 2)


def _scale(v, dsf):
    """Spec 8.5.3.2.8 MV scaling, clipped to 16 bits (`scale_mv`)."""
    x = v * dsf
    m = (abs(x) + 127) >> 8
    return min(max(m if x > 0 else (-m if x < 0 else 0), -32768), 32767)


def _amvp_b(c, li, dsf):
    """The B AMVP pair of list li (`decide_common.cuh:amvp_b`) from
    candidates (dir, m0x, m0y, m1x, m1y) in the order A1, B1, B0, B2, an
    unavailable one with dir 0."""
    def own(e):
        return (e[1], e[2]) if li == 0 else (e[3], e[4])

    def mvp(e):
        if (e[0] >> li) & 1:
            return own(e)
        o = (e[3], e[4]) if li == 0 else (e[1], e[2])
        return (_scale(o[0], dsf), _scale(o[1], dsf))
    ca = mvp(c[0]) if c[0][0] else None
    bp1 = bs = None
    for e in (c[2], c[1], c[3]):
        if bp1 is None and e[0] and (e[0] >> li) & 1:
            bp1 = own(e)
        if bs is None and e[0]:
            bs = mvp(e)
    c0 = ca or bp1 or bs or (0, 0)
    c1 = bp1 if ca else (bs if bp1 and bs else None)
    if c1 is None or c1 == c0:
        c1 = (0, 0)
    return c0, c1


def _pick(me, p):
    """(mvd, mvp index, bins) against the predictor with fewer bins."""
    d = [(me[0] - q[0], me[1] - q[1]) for q in p]
    b = [_bits(*v) for v in d]
    i = int(b[1] < b[0])
    return d[i], i, b[i]


def _merge(c):
    """The indices (into A1, B1, B0, B2) of the merge list's survivors of
    the B pruning (on direction and both MVs), in order."""
    keep = [bool(c[0][0]),
            bool(c[1][0]) and not (c[0][0] and c[1] == c[0]),
            bool(c[2][0]) and not (c[1][0] and c[2] == c[1]),
            bool(c[3][0]) and not (c[0][0] and c[3] == c[0])
            and not (c[1][0] and c[3] == c[1])]
    return [i for i in range(4) if keep[i]]


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _b_costs(lam, mrg_vals, rb, d, bits0, bits1, intra):
    """The six B costs (`decide_cu`), XLA's FMAs: skip values [2] (the
    mean of both lists' for bi), then L0, L1, bi, intra (None: +inf)."""
    from x265amod_tpu_torch.ops.rdoq import fma32
    js = [fma32(lam, _f32(2.0), mrg_vals[0]),
          fma32(lam, _f32(3.0), mrg_vals[1]),
          fma32(lam, (rb[0] + bits0) + 8.0, d[0]),
          fma32(lam, (rb[1] + bits1) + 8.0, d[1]),
          fma32(lam, ((rb[2] + bits0) + bits1) + 10.0, d[2]),
          _f32(float("inf")) if intra is None else intra]
    js = torch.stack(js)
    return js, int(torch.argmin(js))


def _intra_cost(lam, hdr, di):
    from x265amod_tpu_torch.ops.rdoq import fma32
    return fma32(lam, _f32(hdr), di)


def _skip_value(dir_, l0, l1):
    return 0.5 * (l0 + l1) if dir_ == 3 else (l0 if dir_ == 1 else l1)


_DIR_OF_AMVP = {2: 1, 3: 2, 4: 3, 5: 0}


def _final(ch, mrg, me0, me1):
    """The final (dir, m0x, m0y, m1x, m1y) of a B choice, an unused list
    zeroed."""
    if ch <= 1:
        d, m0x, m0y, m1x, m1y = mrg[ch]
    else:
        d, (m0x, m0y), (m1x, m1y) = _DIR_OF_AMVP[ch], me0, me1
    return (d, *((m0x, m0y) if d & 1 else (0, 0)),
            *((m1x, m1y) if d & 2 else (0, 0)))


class _Window:
    """A row walk's commits as the card holds them: each row's own last
    commit (A1), and its register window of the row above's last three
    commits, fed after each step's barrier from the slot of the step's
    parity."""

    def __init__(self, hc, none):
        self.none = none
        self.A = [none] * hc
        self.U = [[none] * 3 for _ in range(hc)]      # steps t-1, t-2, t-3
        self.slot = [[none] * hc for _ in range(2)]

    def publish(self, t, r, pub):
        self.slot[t & 1][r] = pub

    def barrier(self, t, mine):
        for r in range(len(self.A)):
            up = self.slot[t & 1][r - 1] if r else self.none
            self.U[r] = [up, self.U[r][0], self.U[r][1]]
            self.A[r] = mine[r]


def k25_row_walk(wc, hc, grids, d, rb, di, me, lam, sr, dsf, hdr,
                 forced=None):
    """K25 (`csrc/decide_flat.cu:decide_rows_b`) step by step as the
    card runs it: the window (A1 own, B0, B1, B2 from the row above's slot
    after each barrier), the inputs loaded a step ahead, the grid entries
    of both lists at the four neighbours' final MVs and at the zero MV read
    as the step starts, the pruning picking two of them.  A commit is (dir,
    MV0, MV1).  Returns the raster outputs of `decide_b_plain`."""
    n = wc * hc
    none = (0, 0, 0, 0, 0)

    def lookup(g, ctu, mx, my):
        ix, iy = mx >> 2, my >> 2
        if abs(ix) > sr or abs(iy) > sr:
            return _f32(1e18)
        return g[ctu, iy + sr, ix + sr]

    def load(ctu):
        if forced is not None:
            return dict(ctu=ctu, f=[t[ctu] for t in forced])
        return dict(ctu=ctu, lam=lam[ctu], d=d[ctu], rb=rb[ctu], di=di[ctu],
                    me0=tuple(int(v) for v in me[0][ctu]),
                    me1=tuple(int(v) for v in me[1][ctu]))
    i32 = torch.int32
    out = dict(choice=torch.zeros(n, dtype=torch.int64),
               dir=torch.zeros(n, dtype=i32), js=torch.zeros((n, 6)))
    for k in ("mv0", "mv1", "mvd0", "mvd1"):
        out[k] = torch.zeros((n, 2), dtype=i32)
    for k in ("mvp0", "mvp1"):
        out[k] = torch.zeros(n, dtype=i32)
    win, cur = _Window(hc, none), [None] * hc
    for t in range(-1, wc + 2 * (hc - 1)):
        nxt, mine = [None] * hc, [none] * hc
        for r in range(hc):                      # up to the barrier
            x = t - 2 * r
            ctu = r * wc + x
            if 0 <= x + 1 < wc:
                nxt[r] = load(ctu + 1)
            if 0 <= x < wc:
                v = cur[r]
                assert v["ctu"] == ctu
                c = [win.A[r], win.U[r][1], win.U[r][0], win.U[r][2]]
                if forced is None:               # read as the step starts
                    g = [(lookup(grids[0], ctu, e[1], e[2]),
                          lookup(grids[1], ctu, e[3], e[4])) for e in c]
                    gz = (lookup(grids[0], ctu, 0, 0),
                          lookup(grids[1], ctu, 0, 0))
                sel = (_merge(c) + [None, None])[:2]
                mrg = [c[i] if i is not None else (3, 0, 0, 0, 0)
                       for i in sel]
                p0, p1 = _amvp_b(c, 0, dsf[0]), _amvp_b(c, 1, dsf[1])
                if forced is None:
                    (mvd0, mvp0, b0), (mvd1, mvp1, b1) = (
                        _pick(v["me0"], p0), _pick(v["me1"], p1))
                    vals = [_skip_value(m[0], *(g[i] if i is not None
                                                else gz))
                            for m, i in zip(mrg, sel)]
                    js, ch = _b_costs(v["lam"], vals, v["rb"], v["d"], b0,
                                      b1, _intra_cost(v["lam"], hdr,
                                                      v["di"]))
                    out["js"][ctu] = js
                    me0, me1 = v["me0"], v["me1"]
                else:
                    ch, mvd0, mvp0, mvd1, mvp1 = v["f"]
                    ch, mvp0, mvp1 = int(ch), int(mvp0), int(mvp1)
                    mvd0, mvd1 = tuple(mvd0.tolist()), tuple(mvd1.tolist())
                    me0 = tuple(a + b for a, b in zip(p0[mvp0], mvd0))
                    me1 = tuple(a + b for a, b in zip(p1[mvp1], mvd1))
                fin = _final(ch, mrg, me0, me1)
                out["choice"][ctu], out["dir"][ctu] = ch, fin[0]
                out["mv0"][ctu] = torch.tensor(fin[1:3])
                out["mv1"][ctu] = torch.tensor(fin[3:5])
                out["mvd0"][ctu] = torch.tensor(mvd0)
                out["mvd1"][ctu] = torch.tensor(mvd1)
                out["mvp0"][ctu], out["mvp1"][ctu] = mvp0, mvp1
                mine[r] = fin
            win.publish(t, r, mine[r])
        win.barrier(t, mine)
        cur = nxt
    if forced is not None:
        del out["js"]
    return out


def _b_flat_inputs(rng, wc, hc, sr, intra=0.15):
    """Random flat B decide inputs: MVs from a small palette (so the
    pruning bites), sub-pel and at the +-sr edge (4 sr + 3 is inside, 4
    sr + 4 outside: 1e18), some cells where intra wins."""
    n, s = wc * hc, 2 * sr + 1
    edge = [4 * sr + 3, -4 * sr - 4, 4 * sr + 4, -4 * sr]
    pal = rng.integers(-3, 4, (6, 2)) * 4
    pal[0] = (edge[0], edge[1])
    pal[1] = (edge[3], edge[2])

    def mvs():
        mv = pal[rng.integers(0, 6, n)]
        mv = mv + (rng.random((n, 2)) < 0.2) * rng.integers(1, 4, (n, 2))
        return mv.astype(np.int32)
    di = rng.uniform(500, 4000, n)
    di[rng.random(n) < intra] = rng.uniform(0, 50)
    vals = [rng.uniform(0, 3000, (n, s, s)), rng.uniform(0, 3000, (n, s, s)),
            rng.uniform(0, 3000, (n, 3)), rng.uniform(0, 60, (n, 3)), di,
            rng.uniform(2, 40, n)]
    g0, g1, d, rb, di, lam = (torch.as_tensor(v.astype(np.float32))
                              for v in vals)
    return (g0, g1), d, rb, di, (torch.as_tensor(mvs()),
                                 torch.as_tensor(mvs())), lam


_B_GRIDS = [(1, 1, 0), (1, 6, 1), (6, 1, 2), (7, 5, 3), (9, 3, 4)]
_DSF = [(-85, -768), (128, -384), (-256, 256), (-768, 64), (-85, -768)]


@pytest.mark.parametrize("wc,hc,seed", _B_GRIDS)
def test_k25_row_walk_model_equals_the_plain_scan(wc, hc, seed):
    """The flat B row walk (`k25_row_walk`) equals `decide_b_plain`
    exactly, free (choices, directions, MVs, MVDs, MVP indices, cost rows)
    and forced with the plain scan's decisions, on grids of one CTU, one
    column, one row, 7 x 5 and 9 x 3 with dsf values that scale."""
    from x265amod_tpu_torch.ops.decide_flat import Schedule, decide_b_plain
    rng = np.random.default_rng(40 + seed)
    sr, hdr, dsf = 4, 9.5, _DSF[seed]
    grids, d, rb, di, me, lam = _b_flat_inputs(rng, wc, hc, sr)
    sch = Schedule(wc, hc, "cpu")
    want = decide_b_plain(sch, grids, d, rb, di, me, lam, sr, dsf, hdr,
                          want_costs=True)
    got = k25_row_walk(wc, hc, grids, d, rb, di, me, lam, sr, dsf, hdr)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    if wc * hc > 30:
        assert len(set(want["choice"].tolist())) >= 5
        assert (want["dir"] == 3).any() and (want["mvp1"] == 1).any()
    forced = tuple(want[k] for k in ("choice", "mvd0", "mvp0", "mvd1",
                                     "mvp1"))
    want_f = decide_b_plain(sch, None, None, None, None, None, lam, sr, dsf,
                            hdr, forced=forced)
    got_f = k25_row_walk(wc, hc, None, None, None, None, None, lam, sr, dsf,
                         hdr, forced=forced)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k].to(got_f[k].dtype)), k
        assert torch.equal(got_f[k], want[k].to(got_f[k].dtype)), k


# The row walks' sources of a candidate's motion (K17 and K19,
# `csrc/decide_common.cuh:kSources`): 0 the zero MV, 1 left q1, 2 left q3,
# 3 top q2, 4 top q3, 5 top-left q3, 6 top-right q2, 7-9 the ME motion of
# q0, q1, q2; and the ones each CU (CU32, q0..q3) can meet (`need`)
ROW_WALK_NEED = [(0, 2, 4, 5, 6), (0, 1, 3, 4, 5), (0, 1, 3, 4, 5, 6, 7),
            tuple(range(9)), tuple(range(10))]


def k19_row_walk(tree, st1, lam16, lam32, dsf, forced=None):
    """K19 (`csrc/decide_b.cu:decide_rows_b`) step by step as the card runs
    it: a thread a CTU32 row; its window (the left CTU's q1 and q3, its own
    commit; the row above's q2 and q3 of steps t - 1, t - 2 and q3 of t -
    3, fed from the slot of the step's parity after each barrier); the
    inputs loaded a step ahead; and the read set copied as the step starts:
    each CU's grid entries, per list, at the MV of every source it can
    meet (`ROW_WALK_NEED`).  Each decision carries its lists' sources, and a
    merge candidate is priced from the read set at its sources; the lookup
    asserts that the entry was read and equals the grid at the candidate's
    MV.  Returns the raster outputs of `_decide_b_plain`."""
    wc, hc, w16, h16, sr = tree.wc, tree.hc, tree.w16, tree.h16, tree.sr
    n16, n32 = w16 * h16, wc * hc
    s_ = 2 * sr + 1
    none = (0, 0, 0, 0, 0)
    hdr = tree._hdr_bits.item()

    def entry(g, row, ng, mx, my):
        """The grid value of a qpel MV in CU row ``row`` (half-pel rows ng
        on), 1e18 outside +-sr."""
        ix, iy = mx >> 2, my >> 2
        if abs(ix) > sr or abs(iy) > sr:
            return _f32(1e18)
        sub = (mx & 3) != 0 or (my & 3) != 0
        return g[row + (ng if sub else 0), iy + sr, ix + sr]

    def cu_in(i, is32):
        if forced is not None:
            f = forced["c32" if is32 else "c16"]
            return dict(f=[t[i] for t in f])
        sfx = "32" if is32 else "16"
        return dict(d=st1["d" + sfx][i], rb=st1["rb" + sfx][i],
                    lam=(lam32 if is32 else lam16)[i],
                    di=None if is32 else st1["di16"][i],
                    me0=tuple(int(v) for v in st1["mv0_" + sfx][i]),
                    me1=tuple(int(v) for v in st1["mv1_" + sfx][i]))

    def load(i32, c0):
        q16 = [c0, c0 + 1, c0 + w16, c0 + w16 + 1]
        v = dict(i32=i32, cu=[cu_in(i32, True)] + [cu_in(q, False)
                                                     for q in q16])
        v["split"] = None if forced is None else bool(forced["split"][i32])
        return v

    names = {k: torch.zeros(n32, dtype=torch.int32) for k in (
        "split", "ch32", "mvp0_32", "mvp1_32")}
    names.update({k: torch.zeros(n16, dtype=torch.int32) for k in (
        "chq", "mvp0q", "mvp1q", "dir")})
    for k in ("mvd0_32", "mvd1_32"):
        names[k] = torch.zeros((n32, 2), dtype=torch.int32)
    for k in ("mvd0q", "mvd1q", "mv0", "mv1"):
        names[k] = torch.zeros((n16, 2), dtype=torch.int32)
    out = dict(names, jsq=torch.zeros((n16, 6)), js32=torch.zeros((n32, 6)),
               jsplit=torch.zeros(n32), j32=torch.zeros(n32))

    def decide(k, c, srcs, v, pre, me_src, row_out, i):
        """One CU (k: 0 the CU32, 1..4 q0..q3) from candidates c (A1, B1,
        B0, B2) with their sources; returns (choice, final cell, its
        sources, cost)."""
        sel = (_merge(c) + [None, None])[:2]
        mrg = [c[j] if j is not None else (3, 0, 0, 0, 0) for j in sel]
        msrc = [srcs[j] if j is not None else (0, 0) for j in sel]
        p0, p1 = _amvp_b(c, 0, dsf[0]), _amvp_b(c, 1, dsf[1])
        j = None
        if forced is None:
            (mvd0, mvp0, b0), (mvd1, mvp1, b1) = (_pick(v["me0"], p0),
                                                  _pick(v["me1"], p1))
            vals = []
            for m, (s0, s1) in zip(mrg, msrc):
                l0, l1 = pre[(k, 0, s0)], pre[(k, 1, s1)]
                row = (2 * n16 + i, n32) if k == 0 else (i, n16)
                assert torch.equal(l0, entry(tree_grids[0], *row, m[1],
                                             m[2])), (k, m)
                assert torch.equal(l1, entry(tree_grids[1], *row, m[3],
                                             m[4])), (k, m)
                vals.append(_skip_value(m[0], l0, l1))
            intra = None if k == 0 else _intra_cost(v["lam"], hdr, v["di"])
            js, ch = _b_costs(v["lam"], vals, v["rb"], v["d"], b0, b1,
                              intra)
            out["js32" if k == 0 else "jsq"][i] = js
            j = js[ch]
            me0, me1 = v["me0"], v["me1"]
        else:
            ch, mvd0, mvp0, mvd1, mvp1 = v["f"]
            ch, mvp0, mvp1 = int(ch), int(mvp0), int(mvp1)
            mvd0, mvd1 = tuple(mvd0.tolist()), tuple(mvd1.tolist())
            me0 = tuple(a + b for a, b in zip(p0[mvp0], mvd0))
            me1 = tuple(a + b for a, b in zip(p1[mvp1], mvd1))
        fin = _final(ch, mrg, me0, me1)
        s0 = (msrc[ch][0] if ch <= 1 else me_src) if fin[0] & 1 else 0
        s1 = (msrc[ch][1] if ch <= 1 else me_src) if fin[0] & 2 else 0
        ch_k, mvd0_k, mvp0_k, mvd1_k, mvp1_k = row_out
        out[ch_k][i], out[mvp0_k][i], out[mvp1_k][i] = ch, mvp0, mvp1
        out[mvd0_k][i] = torch.tensor(mvd0)
        out[mvd1_k][i] = torch.tensor(mvd1)
        return ch, fin, (s0, s1), j

    tree_grids = None if forced is not None else (st1["grid0"],
                                                  st1["grid1"])
    o32 = ("ch32", "mvd0_32", "mvp0_32", "mvd1_32", "mvp1_32")
    o16 = ("chq", "mvd0q", "mvp0q", "mvd1q", "mvp1q")
    # the window: A holds (left q1, left q3); the slots (q2, q3)
    win, cur = _Window(hc, (none, none)), [None] * hc
    for t in range(-1, wc + 2 * (hc - 1)):
        nxt, mine = [None] * hc, [(none, none)] * hc
        for r in range(hc):                      # up to the barrier
            x = t - 2 * r
            i32, c0 = r * wc + x, 2 * r * w16 + 2 * x
            if 0 <= x + 1 < wc:
                nxt[r] = load(i32 + 1, c0 + 2)
            pub = (none, none)
            if 0 <= x < wc:
                v = cur[r]
                assert v["i32"] == i32
                (l1, l3), (tr2, _), (t2, t3), (_, tl3) = (
                    win.A[r], win.U[r][0], win.U[r][1], win.U[r][2])
                q16 = [c0, c0 + 1, c0 + w16, c0 + w16 + 1]
                pre = {}
                if forced is None:               # read as the step starts
                    src = [none, l1, l3, t2, t3, tl3, tr2] + [
                        (0, *v["cu"][q + 1]["me0"], *v["cu"][q + 1]["me1"])
                        for q in range(3)]
                    for k in range(5):
                        row = (2 * n16 + i32, n32) if k == 0 else (
                            q16[k - 1], n16)
                        for s in ROW_WALK_NEED[k]:
                            for li in range(2):
                                m = src[s][1 + 2 * li:3 + 2 * li]
                                pre[(k, li, s)] = entry(tree_grids[li], *row,
                                                        *m)

                def ext(e, s):
                    return e, (s, s)

                def loc(dec):
                    ch_, fin, srcs, _ = dec
                    return (fin if ch_ <= 4 else none), srcs

                def run(k, cands, me_src, i, rows):
                    c = [e for e, _ in cands]
                    srcs = [s for _, s in cands]
                    return decide(k, c, srcs, v["cu"][k], pre, me_src, rows,
                                  i)
                r32 = run(0, [ext(l3, 2), ext(t3, 4), ext(tr2, 6),
                              ext(tl3, 5)], 0, i32, o32)
                d0 = run(1, [ext(l1, 1), ext(t2, 3), ext(t3, 4),
                             ext(tl3, 5)], 7, q16[0], o16)
                d1 = run(2, [loc(d0), ext(t3, 4), ext(tr2, 6), ext(t2, 3)],
                         8, q16[1], o16)
                d2 = run(3, [ext(l3, 2), loc(d0), loc(d1), ext(l1, 1)], 9,
                         q16[2], o16)
                d3 = run(4, [loc(d2), loc(d1), ext(none, 0), loc(d0)], 0,
                         q16[3], o16)
                qs = (d0, d1, d2, d3)
                if forced is None:
                    js = ((d0[3] + d1[3]) + d2[3]) + d3[3]
                    split = bool(js < r32[3])
                    out["jsplit"][i32], out["j32"][i32] = js, r32[3]
                else:
                    split = v["split"]
                out["split"][i32] = split
                cells = [q[1] if split else r32[1] for q in qs]
                for k in range(4):
                    out["dir"][q16[k]] = cells[k][0]
                    out["mv0"][q16[k]] = torch.tensor(cells[k][1:3])
                    out["mv1"][q16[k]] = torch.tensor(cells[k][3:5])
                mine[r] = (cells[1], cells[3])
                pub = (cells[2], cells[3])
            win.publish(t, r, pub)
        win.barrier(t, mine)
        cur = nxt
    out["split"] = out["split"].bool().reshape(hc, wc)
    for k in ("ch32", "chq"):
        out[k] = out[k].long()
    if forced is not None:
        for k in ("jsq", "js32", "jsplit", "j32"):
            del out[k]
    return out


def _b_tree_inputs(rng, wc, hc, sr, intra=0.15):
    """Random B tree decide inputs (`_decide_b_plain`'s st1 and lambdas):
    MVs from a small palette (so the pruning bites), many sub-pel (the
    half-pel grid rows), some at the +-sr edge and beyond (1e18), CU32
    costs on the scale of four CU16s (so both split and no split win),
    cells where intra wins."""
    n32, n16, s = wc * hc, 4 * wc * hc, 2 * sr + 1
    pal = rng.integers(-3, 4, (6, 2)) * 4
    pal[0] = (4 * sr + 3, -4 * sr - 4)
    pal[1] = (-4 * sr, 4 * sr + 4)

    def mvs(n):
        mv = pal[rng.integers(0, 6, n)]
        mv = mv + (rng.random((n, 2)) < 0.3) * rng.integers(1, 4, (n, 2))
        return torch.as_tensor(mv.astype(np.int32))

    def f(*shape, lo=0.0, hi=3000.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32))
    rows = 2 * (n16 + n32)
    g = [np.concatenate([rng.uniform(0, 3000, (2 * n16, s, s)),
                         rng.uniform(0, 12000, (2 * n32, s, s))])
         for _ in range(2)]
    di = rng.uniform(500, 4000, n16)
    di[rng.random(n16) < intra] = rng.uniform(0, 50)
    assert g[0].shape[0] == rows
    st1 = dict(grid0=torch.as_tensor(g[0].astype(np.float32)),
               grid1=torch.as_tensor(g[1].astype(np.float32)),
               d16=f(n16, 3), rb16=f(n16, 3, hi=60.0),
               di16=torch.as_tensor(di.astype(np.float32)),
               mv0_16=mvs(n16), mv1_16=mvs(n16),
               d32=f(n32, 3, hi=12000.0), rb32=f(n32, 3, hi=120.0),
               mv0_32=mvs(n32), mv1_32=mvs(n32))
    return st1, f(n16, lo=2.0, hi=40.0), f(n32, lo=2.0, hi=40.0)


@pytest.mark.parametrize("wc,hc,seed", _B_GRIDS)
def test_k19_row_walk_model_equals_the_plain_scan(wc, hc, seed):
    """The CTU32 B row walk (`k19_row_walk`) equals
    `BTreeEncoder._decide_b_plain` exactly, free (split, every CU's
    choice, MVDs and MVP indices, the cells' directions and MVs, the cost
    rows and split costs) and forced with the plain scan's decisions, on
    grids of one CTU, one column, one row, 7 x 5 and 9 x 3; every grid
    entry a decision prices is in the read set the step copies."""
    from x265amod_tpu_torch.models.inter_tree import BTreeEncoder
    rng = np.random.default_rng(60 + seed)
    sr, dsf = 4, _DSF[seed]
    tree = BTreeEncoder(32 * wc, 32 * hc, search_range=sr, subme=1,
                        device="cpu")
    st1, lam16, lam32 = _b_tree_inputs(rng, wc, hc, sr)
    maps = dict(lam16=lam16, lam32=lam32)
    want = tree._decide_b_plain(st1, maps, dsf, want_costs=True)
    got = k19_row_walk(tree, st1, lam16, lam32, dsf)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    if wc * hc > 30:
        assert len(set(want["chq"].tolist())) == 6
        assert want["split"].any() and not want["split"].all()
    cells = tree._cell_decisions_b(want)
    kinds = cells["kinds"]
    choice = torch.where(kinds == 0, cells["merge"],
                         torch.where(kinds == 1, 1 + cells["dir"].long(), 5))
    c16 = (choice, cells["mvd0"], cells["mvp0"], cells["mvd1"],
           cells["mvp1"])
    forced = dict(c16=c16, c32=[t[tree._q0_cell] for t in c16],
                  split=want["split"].reshape(-1))
    want_f = tree._decide_b_plain(None, maps, dsf, forced=forced)
    got_f = k19_row_walk(tree, None, lam16, lam32, dsf, forced=forced)
    assert set(got_f) == set(want_f)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k].to(got_f[k].dtype)), k
    for k in ("split", "dir", "mv0", "mv1"):
        assert torch.equal(got_f[k], want[k]), k


# ---- K17: the P decide scan, a thread a CTU32 row ---------------------------

def _amvp_p(c, cur, dsf):
    """The P AMVP pair (`csrc/decide_p.cu:decide_cu`) from committed cells
    (ir = inter | ref << 1, mx, my) in the order A1, B1, B0, B2: A from
    A1, B the first of B0, B1, B2, each scaled to reference ``cur`` by dsf
    [R, R] when it lies on another; B pruned against A, zero-filled."""
    def at(e):
        rf = e[0] >> 1
        if rf == cur:
            return (e[1], e[2])
        f = int(dsf[rf, cur])
        return (_scale(e[1], f), _scale(e[2], f))
    av = [bool(e[0] & 1) for e in c]
    avb = av[1] or av[2] or av[3]
    sa = at(c[0])
    sb = at(c[2] if av[2] else (c[1] if av[1] else c[3]))
    p0 = sa if av[0] else (sb if avb else (0, 0))
    p1 = sb if av[0] and avb and sb != sa else (0, 0)
    return p0, p1


def k17_row_walk(tree, st1, maps, tables, forced=None):
    """K17 (`csrc/decide_p.cu:decide_rows_p`) step by step as the card runs
    it: a thread a CTU32 row; its window (the left CTU's q1 and q3, its own
    commit; the row above's q2 and q3 of steps t - 1, t - 2 and q3 of t -
    3, fed from the slot of the step's parity after each barrier), a cell
    being (inter | ref << 1, mx, my); the inputs loaded a step ahead; and
    the read set copied as the step starts: each CU's grid entry at the
    (MV, reference) of every source it can meet (`ROW_WALK_NEED`, 36
    entries), in the block of grid rows of the source's sub-pel flag and
    reference, at its integer MV clamped into the window.  Each decision
    carries its source, and a merge candidate is priced from the read set
    at its source; the lookup asserts that the entry was read and equals
    the grid at the candidate's motion (1e18 outside +-sr).  Returns the
    raster outputs of `InterTreeEncoder._decide_plain`."""
    from x265amod_tpu_torch.ops.rdoq import fma32
    wc, hc, w16, sr = tree.wc, tree.hc, tree.w16, tree.sr
    n16, n32 = w16 * tree.h16, wc * hc
    dsf, refbits = tables
    nr = refbits.shape[0]
    none = (0, 0, 0)
    grid = None if forced is not None else st1["grid"]

    def rows_of(k, i):
        """(base row, rows per block) of CU k's grid rows."""
        return (2 * nr * n16 + i, n32) if k == 0 else (i, n16)

    def inside(mx, my):
        return abs(mx >> 2) <= sr and abs(my >> 2) <= sr

    def read(base, ng, mx, my, rf):
        """The entry the card copies: the source's block, its integer MV
        clamped into the window."""
        sub = (mx & 3) != 0 or (my & 3) != 0
        ix = min(max(mx >> 2, -sr), sr)
        iy = min(max(my >> 2, -sr), sr)
        return grid[base + ((nr if sub else 0) + rf) * ng, iy + sr, ix + sr]

    def entry(base, ng, mx, my, rf):
        """The plain scan's price of (mx, my) on reference rf."""
        if not inside(mx, my):
            return _f32(1e18)
        sub = (mx & 3) != 0 or (my & 3) != 0
        return grid[base + ((nr if sub else 0) + rf) * ng, (my >> 2) + sr,
                    (mx >> 2) + sr]

    def cu_in(i, is32):
        sfx = "32" if is32 else "16"
        if forced is not None:
            ch, mvd, mvp, ref = (t[i] for t in forced["c" + sfx])
            return dict(ch=int(ch), mvd=tuple(int(v) for v in mvd),
                        mvp=int(mvp), ref=int(ref))
        return dict(d=st1["d" + sfx][i], rb=st1["rb" + sfx][i],
                    lam=maps["lam" + sfx][i],
                    di=None if is32 else st1["di16"][i],
                    me=tuple(int(v) for v in st1["mv" + sfx][i]),
                    ref=int(st1["ref" + sfx][i]))

    def load(i32, c0):
        q16 = [c0, c0 + 1, c0 + w16, c0 + w16 + 1]
        v = dict(i32=i32, cu=[cu_in(i32, True)] + [cu_in(q, False)
                                                     for q in q16])
        v["split"] = None if forced is None else bool(forced["split"][i32])
        return v

    out = {k: torch.zeros(n32, dtype=torch.int32) for k in (
        "split", "ch32", "mvp32", "ref32")}
    out.update({k: torch.zeros(n16, dtype=torch.int32) for k in (
        "chq", "mvpq", "refq", "ref")})
    for k, n in (("mvd32", n32), ("mvdq", n16), ("mv", n16)):
        out[k] = torch.zeros((n, 2), dtype=torch.int32)
    out.update(jsq=torch.zeros((n16, 4)), js32=torch.zeros((n32, 4)),
               jsplit=torch.zeros(n32), j32=torch.zeros(n32))

    def decide(k, cands, v, pre, me_src, rows, i):
        """One CU (k: 0 the CU32, 1..4 q0..q3) from candidates (cell,
        source) in the order A1, B1, B0, B2; returns (choice, final cell,
        its source, cost)."""
        c = [e for e, _ in cands]
        sel = (_merge(c) + [None, None])[:2]
        mrg = [c[j] if j is not None else (1, 0, 0) for j in sel]
        msrc = [cands[j][1] if j is not None else 0 for j in sel]
        cur = v["ref"]
        p = _amvp_p(c, cur, dsf)
        j = None
        if forced is None:
            d = [(v["me"][0] - q[0], v["me"][1] - q[1]) for q in p]
            b = [_bits(*x) for x in d]
            mvp = int(b[1] < b[0])
            mvd = d[mvp]
            base, ng = rows_of(k, i)
            vals = []
            for m, s in zip(mrg, msrc):
                assert (k, s) in pre, (k, s)     # read as the step starts
                val = pre[(k, s)] if inside(m[1], m[2]) else _f32(1e18)
                assert torch.equal(val, entry(base, ng, m[1], m[2],
                                              m[0] >> 1)), (k, m)
                vals.append(val)
            js = torch.stack([
                fma32(v["lam"], _f32(2.0), vals[0]),
                fma32(v["lam"], _f32(3.0), vals[1]),
                fma32(v["lam"], ((v["rb"] + b[mvp]) + refbits[cur]) + 6.0,
                      v["d"]),
                _f32(float("inf")) if k == 0 else _intra_cost(
                    v["lam"], float(tree._hdr_bits), v["di"])])
            ch = int(torch.argmin(js))
            out["js32" if k == 0 else "jsq"][i] = js
            j = js[ch]
            me = v["me"]
        else:
            ch, mvd, mvp = v["ch"], v["mvd"], int(v["mvp"] == 1)
            me = (p[mvp][0] + mvd[0], p[mvp][1] + mvd[1])
        if ch <= 1:
            fin, src = mrg[ch], msrc[ch]
        elif ch == 2:
            fin, src = (1 | cur << 1, *me), me_src
        else:
            fin, src = none, 0
        ch_k, mvd_k, mvp_k, ref_k = rows
        out[ch_k][i], out[mvp_k][i], out[ref_k][i] = ch, mvp, fin[0] >> 1
        out[mvd_k][i] = torch.tensor(mvd)
        return ch, fin, src, j

    o32 = ("ch32", "mvd32", "mvp32", "ref32")
    o16 = ("chq", "mvdq", "mvpq", "refq")
    win, cur = _Window(hc, (none, none)), [None] * hc
    for t in range(-1, wc + 2 * (hc - 1)):
        nxt, mine = [None] * hc, [(none, none)] * hc
        for r in range(hc):                      # up to the barrier
            x = t - 2 * r
            i32, c0 = r * wc + x, 2 * r * w16 + 2 * x
            if 0 <= x + 1 < wc:
                nxt[r] = load(i32 + 1, c0 + 2)
            pub = (none, none)
            if 0 <= x < wc:
                v = cur[r]
                assert v["i32"] == i32
                (l1, l3), (tr2, _), (t2, t3), (_, tl3) = (
                    win.A[r], win.U[r][0], win.U[r][1], win.U[r][2])
                q16 = [c0, c0 + 1, c0 + w16, c0 + w16 + 1]
                pre = {}
                if forced is None:               # read as the step starts
                    src = [(0, 0, 0), (l1[1], l1[2], l1[0] >> 1),
                           (l3[1], l3[2], l3[0] >> 1),
                           (t2[1], t2[2], t2[0] >> 1),
                           (t3[1], t3[2], t3[0] >> 1),
                           (tl3[1], tl3[2], tl3[0] >> 1),
                           (tr2[1], tr2[2], tr2[0] >> 1)] + [
                        (*v["cu"][q + 1]["me"], v["cu"][q + 1]["ref"])
                        for q in range(3)]
                    for k in range(5):
                        base, ng = rows_of(k, i32 if k == 0 else q16[k - 1])
                        for s in ROW_WALK_NEED[k]:
                            pre[(k, s)] = read(base, ng, *src[s])
                    assert len(pre) == 36

                def run(k, cands, me_src, i, rows):
                    return decide(k, cands, v["cu"][k], pre, me_src, rows,
                                  i)

                def loc(dec):
                    return (dec[1] if dec[0] <= 2 else none), dec[2]
                r32 = run(0, [(l3, 2), (t3, 4), (tr2, 6), (tl3, 5)], 0, i32,
                          o32)
                d0 = run(1, [(l1, 1), (t2, 3), (t3, 4), (tl3, 5)], 7,
                         q16[0], o16)
                d1 = run(2, [loc(d0), (t3, 4), (tr2, 6), (t2, 3)], 8,
                         q16[1], o16)
                d2 = run(3, [(l3, 2), loc(d0), loc(d1), (l1, 1)], 9, q16[2],
                         o16)
                d3 = run(4, [loc(d2), loc(d1), (none, 0), loc(d0)], 0,
                         q16[3], o16)
                qs = (d0, d1, d2, d3)
                if forced is None:
                    js = ((d0[3] + d1[3]) + d2[3]) + d3[3]
                    split = bool(js < r32[3])
                    out["jsplit"][i32], out["j32"][i32] = js, r32[3]
                else:
                    split = v["split"]
                out["split"][i32] = split
                k32 = (1 | (r32[1][0] & ~1), r32[1][1], r32[1][2])
                cells = [q[1] if split else k32 for q in qs]
                for k in range(4):
                    out["mv"][q16[k]] = torch.tensor(cells[k][1:])
                    out["ref"][q16[k]] = cells[k][0] >> 1
                mine[r] = (cells[1], cells[3])
                pub = (cells[2], cells[3])
            win.publish(t, r, pub)
        win.barrier(t, mine)
        cur = nxt
    out["split"] = out["split"].bool().reshape(hc, wc)
    for k in ("ch32", "chq"):
        out[k] = out[k].long()
    if forced is not None:
        for k in ("jsq", "js32", "jsplit", "j32"):
            del out[k]
    return out


def _p_tree_inputs(rng, wc, hc, sr, nr, intra=0.15):
    """Random P tree decide inputs (`_decide_plain`'s st1 and lambdas):
    MVs from a small palette (so the pruning bites), many sub-pel (the
    half-pel blocks of grid rows), some at the +-sr edge and beyond (1e18),
    references drawn from all R (so neighbours lie on other references
    than the CU's and AMVP scales them), CU32 costs on the scale of four
    CU16s, cells where intra wins."""
    n32, n16, s = wc * hc, 4 * wc * hc, 2 * sr + 1
    pal = rng.integers(-3, 4, (6, 2)) * 4
    pal[0] = (4 * sr + 3, -4 * sr - 4)
    pal[1] = (-4 * sr, 4 * sr + 4)

    def mvs(n):
        mv = pal[rng.integers(0, 6, n)]
        mv = mv + (rng.random((n, 2)) < 0.3) * rng.integers(1, 4, (n, 2))
        return torch.as_tensor(mv.astype(np.int32))

    def refs(n):
        return torch.as_tensor(rng.integers(0, nr, n).astype(np.int32))

    def f(*shape, lo=0.0, hi=3000.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32))
    g = np.concatenate([rng.uniform(0, 3000, (2 * nr * n16, s, s)),
                        rng.uniform(0, 12000, (2 * nr * n32, s, s))])
    di = rng.uniform(500, 4000, n16)
    di[rng.random(n16) < intra] = rng.uniform(0, 50)
    st1 = dict(grid=torch.as_tensor(g.astype(np.float32)), d16=f(n16),
               rb16=f(n16, hi=60.0),
               di16=torch.as_tensor(di.astype(np.float32)), mv16=mvs(n16),
               ref16=refs(n16), d32=f(n32, hi=12000.0),
               rb32=f(n32, hi=120.0), mv32=mvs(n32), ref32=refs(n32))
    return st1, dict(lam16=f(n16, lo=2.0, hi=40.0),
                     lam32=f(n32, lo=2.0, hi=40.0))


@pytest.mark.parametrize("nr", [1, 2, 4])
@pytest.mark.parametrize("wc,hc,seed", _B_GRIDS)
def test_k17_row_walk_model_equals_the_plain_scan(wc, hc, seed, nr):
    """The CTU32 P row walk (`k17_row_walk`) equals
    `InterTreeEncoder._decide_plain` exactly, free (split, every CU's
    choice, MVD, MVP index and reference, the cells' MVs and references,
    the cost rows and split costs) and forced with the plain scan's
    decisions, on grids of one CTU, one column, one row, 7 x 5 and 9 x 3,
    at R = 1, 2 and 4; every grid entry a decision prices is in the 36
    entries the step copies."""
    from x265amod_tpu_torch.models.inter_tree import InterTreeEncoder
    from x265amod_tpu_torch.models.mvpred import ref_list_tables
    rng = np.random.default_rng(80 + 10 * seed + nr)
    sr = 4
    tree = InterTreeEncoder(32 * wc, 32 * hc, search_range=sr, subme=1,
                            device="cpu")
    st1, maps = _p_tree_inputs(rng, wc, hc, sr, nr)
    dsf, bits = ref_list_tables(9, [8, 5, 3, 0][:nr])
    tables = (torch.as_tensor(dsf), torch.as_tensor(bits))
    want = tree._decide_plain(st1, maps, tables, want_costs=True)
    got = k17_row_walk(tree, st1, maps, tables)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    if wc * hc > 30:
        assert len(set(want["chq"].tolist())) == 4
        assert want["split"].any() and not want["split"].all()
        assert (want["js32"][:, :2] >= 1e18).any()
        if nr > 1:
            assert (want["ref"] > 0).any() and (want["refq"] == 0).any()
    cells = tree._cell_decisions(want)
    kinds = cells["kinds"]
    forced = dict(c16=(torch.where(kinds == 0, cells["merge"],
                                   torch.where(kinds == 1, 2, 3)),
                       cells["mvd"], cells["mvp"], cells["ref"]),
                  split=want["split"].reshape(-1))
    forced["c32"] = [t[tree._q0_cell] for t in forced["c16"]]
    want_f = tree._decide_plain(None, maps, tables, forced=forced)
    got_f = k17_row_walk(tree, None, maps, tables, forced=forced)
    assert set(got_f) == set(want_f)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k].to(got_f[k].dtype)), k
    for k in ("split", "mv", "ref"):
        assert torch.equal(got_f[k], want[k].to(got_f[k].dtype)), k
