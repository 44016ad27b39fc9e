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
