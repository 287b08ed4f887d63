"""Holds the slow presets' mechanisms, as the timed path of the cell
slow_1080p.crowd or slower_1080p.crowd runs them on the card, to the
benchmark's plain reference (encbench/reference/):

- RDOQ (models/residual._rdoq_x64): every level of a sample of the TBs
  handed to it that hold a level, against reference.rdoq.rdoq_block:
  exact;
- the dense integer search (engine/me._int_stage at S=16, R=57): the
  motion vector of a sample of the blocks it searched against
  reference.dense.search_block, and the SAD at it, read back from the
  kernel's float32 cost: exact; the cost within 2^-23 of the reference's;
- the explicit inter RQT (models/inter_residual._rqt_split, tu-inter-depth
  2: slower only): the split choice of a sample of the CUs it decided,
  against reference.rqt.split_decision wherever the two costs differ by
  more than reference.rqt.RQT_TIE; at least 512 such CUs.

It encodes the cell's first 30 pictures from its IDR (its configuration,
its pictures from the seed: encbench.spec, encbench.frames), then
flushes; the samples are drawn from the seed. A control breaks the path
under the wrappers, and the check must then fail: ``rdoq_plain`` hands
back the deadzone levels, ``psy_off`` drops the psy-RDOQ credit,
``no_mvcost`` runs the dense sweep without its mv cost, ``rqt_flip``
inverts the RQT's choice, ``rqt_no_tree`` drops the split's tree charge
(inter_residual.RQT_TREE_BINS).

    python3 tools/torch_slow_reference_check.py --seed 5 \
        [--cell slower_1080p.crowd] [--control psy_off]

Prints one JSON line; exit 0 when every comparison holds, 1 otherwise,
2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from encbench import frames, spec  # noqa: E402
from encbench.reference import dense, rdoq, rqt  # noqa: E402

CELLS = ("slow_1080p.crowd", "slower_1080p.crowd")
PICTURES = 30
# samples kept: RDOQ TBs, dense-search blocks, RQT CUs; lanes drawn from
# each call (the RQT is called once a picture and CU size: more lanes)
RDOQ_TBS, DENSE_BLOCKS, RQT_CUS, PER_CALL, RQT_PER_CALL = \
    2048, 96, 4096, 8, 128
# the RQT decisions compared (outside the tie margin) a pass needs
RQT_LEAST = 512
CONTROLS = ("none", "rdoq_plain", "psy_off", "no_mvcost", "rqt_flip",
            "rqt_no_tree")


class Reservoir:
    """A uniform sample of `size` items of a stream, drawn from rng; an
    item is made (copied off the device) only when it is kept."""

    def __init__(self, size, rng):
        self.size, self.rng, self.seen, self.kept = size, rng, 0, []

    def offer(self, make):
        if len(self.kept) < self.size:
            self.kept.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = make()
        self.seen += 1


def patch(orig, wrapper, patched):
    """Put `wrapper` wherever a module of the port holds `orig`."""
    for m in list(sys.modules.values()):
        if getattr(m, "__name__", "").startswith("x265_tpu_torch"):
            for k, v in list(vars(m).items()):
                if v is orig:
                    setattr(m, k, wrapper)
                    patched.append((m, k, orig))


def cpu(t):
    return t.detach().to("cpu")


def install(control, rng):
    """Wrap the entry points; returns (reservoirs, patched)."""
    from x265_tpu_torch.engine import me
    from x265_tpu_torch.models import inter_residual, residual
    from x265_tpu_torch.ops.cuda_kernels import sad_sweep_argmin
    res = {"rdoq": Reservoir(RDOQ_TBS, rng),
           "dense": Reservoir(DENSE_BLOCKS, rng),
           "rqt": Reservoir(RQT_CUS, rng)}
    patched, lam_now = [], []

    def lanes(N, among=None, k=PER_CALL):
        pool = np.arange(N) if among is None else among
        return rng.choice(pool, size=min(len(pool), k),
                          replace=False).tolist()

    orig_rdoq = residual._rdoq_x64

    def rdoq_entry(coeff, lvl, qp, n, bd, scaling=False, is_intra=False,
                   consts=None, psy_fx=0):
        if control == "rdoq_plain":
            out = lvl.clone()
        else:
            out = orig_rdoq(coeff, lvl, qp, n, bd, scaling, is_intra, consts,
                            0 if control == "psy_off" else psy_fx)
        k = None if consts is None else cpu(consts).tolist()
        # a TB without a level is none of RDOQ's business: every
        # candidate is 0 there; sample among the others
        held = cpu(lvl.reshape(lvl.shape[0], -1).ne(0).any(1))
        for i in lanes(coeff.shape[0], held.nonzero()[:, 0].numpy()):
            res["rdoq"].offer(lambda i=i: (
                cpu(coeff[i]), cpu(lvl[i]), int(qp[i]), n, bd, scaling, k,
                int(psy_fx), cpu(out[i])))
        return out

    orig_fused, orig_int = me._motion_fused, me._int_stage

    def fused_entry(cur, refs_big, lam, *a, **kw):
        lam_now.append(float(np.float32(lam)))
        try:
            return orig_fused(cur, refs_big, lam, *a, **kw)
        finally:
            lam_now.pop()

    def int_entry(cur, ref_R, mvcost_flat, S, R):
        if control == "no_mvcost":
            mvcost_flat = torch.zeros_like(mvcost_flat)
        mv = orig_int(cur, ref_R, mvcost_flat, S, R)
        if S != 16 or R != 57 or not lam_now:
            return mv
        nby, nbx = mv.shape[:2]
        kernel = {}

        def block(b):
            if not kernel:           # the kernel's float32 cost, once a call
                kernel["cost"] = cpu(sad_sweep_argmin(
                    cur.to(torch.int16).contiguous(),
                    ref_R.to(torch.int16).contiguous(),
                    mvcost_flat.to(torch.float32).contiguous(), S, R)[1])
                kernel["mvcost"] = cpu(mvcost_flat)
            by, bx = divmod(b, nbx)
            return (cpu(cur[by * S:(by + 1) * S, bx * S:(bx + 1) * S]),
                    cpu(ref_R[by * S:by * S + S + 2 * R,
                              bx * S:bx * S + S + 2 * R]),
                    lam_now[-1], S, R, tuple(cpu(mv[by, bx]).tolist()),
                    float(kernel["cost"][by, bx]), kernel["mvcost"])
        for b in lanes(nby * nbx):
            res["dense"].offer(lambda b=b: block(b))
        return mv

    orig_split = inter_residual._rqt_split

    def rqt_entry(resid, whole, quads, qpy, rate_kk):
        split = orig_split(resid, whole, quads, qpy, rate_kk)
        if control == "rqt_flip":
            split = ~split
        kl, kc = cpu(rate_kk).tolist()
        for i in lanes(qpy.shape[0], k=RQT_PER_CALL):
            res["rqt"].offer(lambda i=i: (
                [cpu(r[i]) for r in resid],
                [(cpu(lv[i]), cpu(rr[i])) for lv, rr in whole],
                [(cpu(lv[i]), cpu(rr[i])) for lv, rr in quads],
                int(qpy[i]), kl, kc, bool(split[i])))
        return split

    patch(orig_rdoq, rdoq_entry, patched)
    patch(orig_fused, fused_entry, patched)
    patch(orig_int, int_entry, patched)
    patch(orig_split, rqt_entry, patched)
    if control == "rqt_no_tree":
        patched.append((inter_residual, "RQT_TREE_BINS",
                        inter_residual.RQT_TREE_BINS))
        inter_residual.RQT_TREE_BINS = 0.0
    return res, patched


def check_rdoq(kept):
    bad = changed = psy = psy_moved = 0
    for coeff, lvl, qp, n, bd, scaling, k, psy_fx, out in kept:
        if scaling:
            raise ValueError("scaling lists: the reference is flat only")
        want = rdoq.rdoq_block(coeff, lvl, qp, n, bd, k, psy_fx)
        bad += not torch.equal(out.to(torch.int64), want)
        changed += not torch.equal(want, lvl.to(torch.int64))
        if psy_fx:
            psy += 1
            psy_moved += not torch.equal(
                want, rdoq.rdoq_block(coeff, lvl, qp, n, bd, k, 0))
    return {"tbs": len(kept), "mismatched": bad, "moved_by_rdoq": changed,
            "with_psy": psy, "moved_by_psy": psy_moved}


def check_dense(kept):
    mv_bad = sad_bad = 0
    gap = 0.0
    for cur, win, lam, S, R, mv, c32, lam_cost in kept:
        want, sad, c64 = dense.search_block(cur, win, 0, 0, S, R, lam)
        mv_bad += mv != want
        # the SAD at the port's mv, read back from the kernel's cost
        port_sad = round(c32 - float(lam_cost[(mv[1] + R) * (2 * R + 1)
                                              + mv[0] + R]))
        sad_bad += port_sad != dense.cost_at(cur, win, 0, 0, S, R, lam,
                                             mv)[0]
        if mv == want:
            gap = max(gap, abs(c32 - c64) / max(c64, 1.0))
    return {"blocks": len(kept), "mv_mismatched": mv_bad,
            "sad_mismatched": sad_bad, "max_cost_rel_gap": gap,
            "cost_within_f32": gap <= 2.0 ** -23}


def check_rqt(kept):
    bad = ties = splits = 0
    for resid, whole, quads, qp, kl, kc, got in kept:
        want, a, b = rqt.split_decision(resid, whole, quads, qp, kl, kc)
        if abs(a - b) <= rqt.RQT_TIE * max(abs(a), abs(b)):
            ties += 1
            continue
        splits += want
        bad += got != want
    return {"cus": len(kept), "compared": len(kept) - ties, "ties": ties,
            "split": splits, "mismatched": bad}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cell", choices=CELLS, default=CELLS[0])
    ap.add_argument("--control", choices=CONTROLS, default="none")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.utils import profiling
    cell = spec.load_cell(a.cell)
    cfg, mix = cell["config_spec"], cell["traffic_spec"]
    pool = frames.make_pool(mix, cfg["width"], cfg["height"], a.seed,
                            cfg["bit_depth"])
    order = frames.feed_order(mix, len(pool), PICTURES,
                              cell.get("window", {}).get("start", 0))
    rng = np.random.default_rng([a.seed, 0x51])
    res, patched = install(a.control, rng)
    profiling.reset()
    t = time.perf_counter()
    try:
        enc = Encoder(spec.params(cfg), device="cuda")
        enc.headers()
        for i in order:
            enc.encode_frame(*(p.copy() for p in pool[i]))
        enc.flush()
        torch.cuda.synchronize()
    finally:
        for m, k, orig in reversed(patched):
            setattr(m, k, orig)
    encode_s = time.perf_counter() - t
    counts = profiling.counters()
    t = time.perf_counter()
    out = {"cell": a.cell, "seed": a.seed, "pictures": PICTURES,
           "control": a.control, "encode_s": encode_s,
           "seen": {k: r.seen for k, r in res.items()},
           "counters": {k: counts[k] for k in (
               "rqt.tried", "rqt.won", "slicetype.minigops",
               "slicetype.bframes")},
           "rdoq": check_rdoq(res["rdoq"].kept),
           "dense": check_dense(res["dense"].kept),
           "rqt": check_rqt(res["rqt"].kept)}
    out["check_s"] = time.perf_counter() - t
    # the RQT runs, and must be compared, where the configuration gives
    # tu-inter-depth 2
    rqt_on = enc.param.tu_inter_depth >= 2
    out["pass"] = bool(
        out["rdoq"]["tbs"] and not out["rdoq"]["mismatched"]
        and out["dense"]["blocks"] and not out["dense"]["mv_mismatched"]
        and not out["dense"]["sad_mismatched"]
        and out["dense"]["cost_within_f32"]
        and not out["rqt"]["mismatched"]
        and (out["rqt"]["compared"] >= RQT_LEAST or not rqt_on))
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
