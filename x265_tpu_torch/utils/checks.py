"""Runtime invariant checks for the device compute paths.

The x265 analog of building with sanitizers for the regression farm
(SURVEY §5.2): with the checks on, a quantizer overflow or an
out-of-range QP inside a batched transform chain fails LOUDLY with a
message instead of silently corrupting the bitstream downstream.

Off by default; enable with
    X265TPU_CHECKIFY=1
for debug runs and CI canaries. Each check is a boolean formed on the
device; a checked call reads them together once (one synchronise), so
the checks cost nothing when they are off and one round trip per call
when they are on. No device-side assert is used: a failed one leaves the
CUDA context unusable, where a raised CheckError leaves it as it was.
"""
from __future__ import annotations

import os

import torch

# the messages of the JAX package's checkify assertions, in their order
QP_RANGE = "tq_chain: QP out of range"
RESI_RANGE = "tq_chain: residual exceeds the bit-depth dynamic range"
LEVEL_OVERFLOW = "tq_chain: coefficient level overflow"
RRES_OVERFLOW = "tq_chain: reconstruction residual overflow"


class CheckError(RuntimeError):
    """An invariant of a checked device computation does not hold."""


def enabled() -> bool:
    return os.environ.get("X265TPU_CHECKIFY") == "1"


def raise_failed(flags, messages) -> None:
    """Read the device booleans `flags` (one synchronise) and raise
    CheckError with the message of the first that is false."""
    ok = torch.stack([f.reshape(()) for f in flags]).cpu().tolist()
    for good, msg in zip(ok, messages):
        if not good:
            raise CheckError(msg)


def checked_tq_chain(resi, qp, scan_sel, n, dst, is_intra, bd, sdh,
                     do_rdoq, lossless, scaling=False, consts=None,
                     psy_fx=0):
    """tq_chain with its four invariants checked; raises CheckError on the
    first violated one. The chain runs on the QP clamped to its range (a
    no-op when the QP check holds), so a bad QP cannot index a table
    past its end on the device before the check is read."""
    from x265_tpu_torch.models.residual import _tq_chain
    qp_max = 51 + 6 * (bd - 8)
    qp_ok = ((qp >= 0) & (qp <= qp_max)).all()
    resi_ok = (resi.abs() < (1 << bd)).all()
    lvl, rres, cbf = _tq_chain(resi, qp.clamp(0, qp_max), scan_sel, n, dst,
                               is_intra, bd, sdh, do_rdoq, lossless,
                               scaling, consts, psy_fx)
    raise_failed((qp_ok, resi_ok, (lvl.abs() <= 32767).all(),
                  (rres.abs() <= 32767).all()),
                 (QP_RANGE, RESI_RANGE, LEVEL_OVERFLOW, RRES_OVERFLOW))
    return lvl, rres, cbf
