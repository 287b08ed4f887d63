"""ops.cuda_kernels.rd_tb_cost, the RD passes' TB cost chain in one call,
against the chain as models/rdo.py and models/intra_rdo.py summed it before
(models/residual._tq_chain, then _sse, _tb_rate_bits_j and the psy energy
of _psy_energy8), and on the card the kernel (csrc/rd_cost.cu) against its
plain version.

Every batch holds the edge cases: an all-zero residual, residuals at
+-(2^bd - 1) at QP 0 (levels clamped at 32767 at 32x32 and 10 bits), dense
noise whose rate is well above 512 bits, and smooth blocks. Exact: the
chain is integer arithmetic up to one float32 conversion per TB.

This file imports neither jax nor the JAX package; the card's case runs
with `python -m pytest tests/test_torch_rd_tb_cost.py -m gpu --noconftest`.
"""
import numpy as np
import pytest
import torch

from x265_tpu_torch.hevc.rate_model import rdoq_rate_consts
from x265_tpu_torch.models.rdo import (_psy_energy8, _sse, _tb_costs,
                                       _tb_rate_bits_j)
from x265_tpu_torch.models.residual import _tq_chain
from x265_tpu_torch.ops import cuda_kernels, cuda_mc
from x265_tpu_torch.utils import profiling
import torch_port_util  # noqa: F401  (one torch thread)

# (is_intra, sdh, scaling, bd, want_psy): with S in 8/16/32 and RDOQ off and
# on, every flag and both bit depths meet every size and both RDOQ branches
FLAGS = [(False, True, False, 8, True), (True, True, True, 10, True),
         (False, False, True, 8, False), (True, False, False, 10, False)]
CASES = [(S, rdoq) + f for S in (8, 16, 32) for rdoq in (False, True)
         for f in FLAGS]


def tb_batch(S, bd, seed, n_random=5):
    """(src, pred, qp) int32 CPU tensors: the edge cases, then n_random
    noisy blocks at random QPs."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    qmax = 51 + 6 * (bd - 8)
    src, pred, qp = [], [], []

    def add(s, p, q):
        src.append(s)
        pred.append(p)
        qp.append(q)
    full = np.full((S, S), maxv)
    zero = np.zeros((S, S), np.int64)
    flat = rng.integers(0, maxv + 1, (S, S))
    add(flat, flat, 30)                               # all-zero residual
    add(full, zero, 0)                                # +maxv at QP 0
    add(zero, full, 0)                                # -maxv at QP 0
    add(rng.integers(0, maxv + 1, (S, S)),            # dense noise: > 512 bits
        rng.integers(0, maxv + 1, (S, S)), 4)
    yy, xx = np.mgrid[:S, :S]
    ramp = (yy * 3 + xx * 5) % (maxv + 1)
    add(ramp, np.clip(ramp + rng.integers(-3, 4, (S, S)), 0, maxv), 22)
    for _ in range(n_random):
        p = rng.integers(0, maxv + 1, (S, S))
        amp = int(rng.choice([2, 8, 40, maxv]))
        s = np.clip(p + rng.integers(-amp, amp + 1, (S, S)), 0, maxv)
        add(s, p, int(rng.integers(0, qmax + 1)))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return t(np.stack(src)), t(np.stack(pred)), t(np.array(qp))


def rate_row(is_intra, qp=30):
    """A consts row of hevc/rate_model.py, as the RD passes pick it."""
    return torch.from_numpy(np.array(
        rdoq_rate_consts(0 if is_intra else 2, qp)[0], np.int32))


def chain_as_before(src, pred, qp, rk, S, is_intra, bd, sdh, do_rdoq,
                    scaling, want_psy):
    """(sse, rate bits, psy) float32 and the levels, as the RD passes
    computed them from the chain before rd_tb_cost."""
    resi = src - pred
    lvl, rres, cbf = _tq_chain(
        resi, qp, torch.zeros((resi.shape[0],), dtype=torch.int32), S,
        False, is_intra, bd, sdh, do_rdoq, False, scaling)
    sse = _sse(resi, rres)
    rate = torch.where(cbf, _tb_rate_bits_j(lvl, rk), 0.0)
    if want_psy:
        rec = (pred + rres).clamp(0, (1 << bd) - 1)
        pc = (_psy_energy8(src) - _psy_energy8(rec)).abs().sum(
            dim=1, dtype=torch.int64).to(torch.float32)
    else:
        pc = torch.zeros_like(sse)
    return sse, rate, pc, lvl


@pytest.mark.parametrize("S,do_rdoq,is_intra,sdh,scaling,bd,want_psy", CASES)
def test_tb_costs_equal_the_chain(S, do_rdoq, is_intra, sdh, scaling, bd,
                                  want_psy):
    """The RD passes' (sse, rate, psy) through rd_tb_cost's plain version
    equal the chain's, bit for bit; RDOQ's TBs are counted once."""
    src, pred, qp = tb_batch(S, bd, seed=S * 7 + bd + 3 * do_rdoq)
    rk = rate_row(is_intra)
    before = profiling.counters().get("rdoq.tbs", 0)
    got = _tb_costs(src, pred, qp, rk, S, is_intra, want_psy, bd, sdh,
                    do_rdoq, scaling)
    counted = profiling.counters().get("rdoq.tbs", 0) - before
    assert counted == (src.shape[0] if do_rdoq else 0)
    *want, lvl = chain_as_before(src, pred, qp, rk, S, is_intra, bd, sdh,
                                 do_rdoq, scaling, want_psy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
    # the batch reaches the edges it is built for
    assert not lvl[0].any()                       # the all-zero residual
    assert (want[1] > 512).any()                  # a rate above 512 bits
    if S == 32 and bd == 10:
        assert int(lvl.abs().max()) == 32767
    if want_psy:
        assert (want[2] > 0).any()


def test_rd_tb_cost_refuses_what_the_kernel_does_not_take():
    src, pred, qp = tb_batch(8, 8, seed=1, n_random=0)
    rk = rate_row(False)
    args = (False, 8, True, False, False, False)
    with pytest.raises(TypeError):
        cuda_kernels.rd_tb_cost(src.to(torch.int16), pred, qp, rk, *args)
    with pytest.raises(ValueError):
        cuda_kernels.rd_tb_cost(src[:, :4, :4].contiguous(),
                                pred[:, :4, :4].contiguous(), qp, rk, *args)
    with pytest.raises(ValueError):
        cuda_kernels.rd_tb_cost(src, pred, qp[:2].contiguous(), rk, *args)
    with pytest.raises(ValueError):
        cuda_kernels.rd_tb_cost(src, pred, qp, rk, False, 12, True, False,
                                False, False)


@pytest.mark.gpu
def test_rd_tb_cost_kernel_equals_plain_on_the_card():
    """Every case above, and batches that fill several CTAs and end in a
    ragged one, on the card: the kernel's four outputs equal the plain
    version's exactly, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    dev = torch.device("cuda")
    for (S, do_rdoq, is_intra, sdh, scaling, bd, want_psy) in CASES:
        for n_random in (5, 77):
            src, pred, qp = (t.to(dev) for t in tb_batch(
                S, bd, seed=S + bd + n_random, n_random=n_random))
            rk = rate_row(is_intra).to(dev)
            args = (src, pred, qp, rk, is_intra, bd, sdh, do_rdoq, scaling,
                    want_psy)
            before = cuda_mc.launches["rd_tb_cost"]
            got = cuda_kernels.rd_tb_cost(*args)
            assert cuda_mc.launches["rd_tb_cost"] == before + 1
            want = cuda_kernels.rd_tb_cost_plain(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("sse", "rate", "psy", "cbf"), got, want):
                assert g.dtype == w.dtype, name
                assert torch.equal(g, w), (
                    f"{name} S={S} rdoq={do_rdoq} intra={is_intra} "
                    f"sdh={sdh} scaling={scaling} bd={bd} psy={want_psy}: "
                    f"{(g != w).nonzero()[:8, 0].tolist()} "
                    f"{g[g != w][:8].tolist()} {w[g != w][:8].tolist()}")
