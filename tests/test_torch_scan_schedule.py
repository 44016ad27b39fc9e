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

And the schedule of K24, the flat P decide scan on the card (a thread a
CTU row): its walk visits each diagonal's CTUs at that diagonal's step,
and every CTU's neighbours commit one to three steps before it, as the
row's register window holds them; a step-by-step model of the walk
(`k24_row_walk`) equals `decide_p_plain`, free and forced; and every inter
CTU's final MV is its mrg0, mrg1 or ME MV.
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
