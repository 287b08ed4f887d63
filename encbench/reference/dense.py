"""The dense integer motion search, written plainly: one block at a time,
every displacement of the window tried (x265 --me full; the port's
`slow` preset runs it for `--me star`, see below), costs in float64.

For an S x S block at (bx S, by S) of the current plane and a reference
padded by R on every side (ref_pad[y + R, x + R] is the reference at
(x, y)), every displacement (dx, dy) in [-R, R]^2 costs

    SAD(dx, dy) + lambda * (bits(4 dx) + bits(4 dy)),
    bits(v) = 2 floor(log2(2 |v| + 1)) + 1      (a quarter-pel component)

and the block's motion vector is the least cost's displacement, the first
in the order d = (dy + R) (2R + 1) + (dx + R) among equal costs. lambda
is the search's sqrt(0.85 * 2^((qp - 12) / 3)).

Departures from x265: x265's star search (motion.cpp) starts from the
predictors, walks a diamond and a star of widening rings and refines
from the best point, and prices each mv against its predictor (mvd),
not against zero; the port searches every displacement of the window
and prices mvs against zero here, taking the predictor only in its
sub-pel stages.
"""
from __future__ import annotations

import torch


def mv_bits(v: torch.Tensor) -> torch.Tensor:
    """Bits of quarter-pel mv components v (an exp-Golomb length)."""
    a = 2 * v.abs().to(torch.int64) + 1
    return (2 * sum((a >= (1 << b)).to(torch.int64) for b in range(1, 40))
            + 1).to(torch.float64)


def search_block(cur, ref_pad, bx: int, by: int, S: int, R: int,
                 lam: float):
    """((dx, dy), sad, cost) of block (bx, by): its least-cost
    displacement, the SAD there and the cost."""
    blk = torch.as_tensor(cur)[by * S:(by + 1) * S,
                               bx * S:(bx + 1) * S].to(torch.int64)
    win = torch.as_tensor(ref_pad)[by * S:by * S + S + 2 * R,
                                   bx * S:bx * S + S + 2 * R].to(torch.int64)
    n = 2 * R + 1
    cand = win.unfold(0, S, 1).unfold(1, S, 1)          # [n, n, S, S]
    sad = (cand - blk).abs().sum(dim=(2, 3))            # [dy, dx]
    d = torch.arange(-R, R + 1)
    bits = mv_bits(4 * d)
    cost = sad.to(torch.float64) + float(lam) * (bits[:, None] + bits[None, :])
    flat = cost.reshape(-1)
    first = int(torch.nonzero(flat == flat.min())[0, 0])
    dy, dx = divmod(first, n)
    return (dx - R, dy - R), int(sad[dy, dx]), float(flat[first])


def cost_at(cur, ref_pad, bx: int, by: int, S: int, R: int, lam: float,
            mv):
    """(sad, cost) of block (bx, by) at displacement mv = (dx, dy)."""
    dx, dy = mv
    blk = torch.as_tensor(cur)[by * S:(by + 1) * S,
                               bx * S:(bx + 1) * S].to(torch.int64)
    y, x = by * S + R + dy, bx * S + R + dx
    ref = torch.as_tensor(ref_pad)[y:y + S, x:x + S].to(torch.int64)
    sad = int((ref - blk).abs().sum())
    bits = mv_bits(torch.tensor([4 * dx, 4 * dy])).sum()
    return sad, sad + float(lam) * float(bits)
