"""The finalizer split (tests/test_finalizer_split.py) in the port: with
the device's inter residual (Encoder.use_tpu_residual = True) or with
every TB quantized by the native walk (False), the port's streams are
byte-identical to each other and to the JAX package's, in the four
configurations of the JAX test (Main10: tests/test_torch_three_way.py)."""
import numpy as np
import pytest

from torch_port_util import switch_streams


def _clip(n=6, seed=7, w=176, h=144):
    """tests/test_finalizer_split.py's clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(int)
    out = []
    for i in range(n):
        y = np.clip(np.roll(base, 3 * i, 1) + np.roll(base // 3, i, 0)
                    + rng.integers(-4, 5, (h, w)), 0, 255)
        out.append((y.astype(np.uint8),
                    np.clip(120 + (y[::2, ::2] >> 3), 0, 255)
                    .astype(np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _split_params(**kw):
    def build(mod):
        p = mod.param_default_preset("medium")
        p.rc_mode, p.qp = mod.RC_CQP, 30
        for k, v in kw.items():
            setattr(p, k, v)
        return p
    return build


@pytest.mark.parametrize("cfg", [
    dict(),                                      # medium: B frames, SAO, AQ
    dict(bframes=0, sao=False, aq_mode=0, cu_tree=False),   # plain IPPP
    dict(rdoq_level=2, ref=2),                   # RDOQ + multiref
    dict(sign_hide=False, deblock=False),
], ids=["medium", "ippp", "rdoq_ref2", "nosdh_nodeblock"])
def test_split_streams_identical(cfg):
    off, on, jax = switch_streams(
        _split_params(**cfg), _clip(),
        [("torch", {"use_tpu_residual": False}), ("torch", {}),
         ("jax", {})])
    assert off == on == jax, (len(off), len(on), len(jax), cfg)
