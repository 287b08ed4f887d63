"""The native writer against the Python oracle writer (Encoder.use_native
= False) through whole encodes, as the JAX package's tests hold them:
the transform-skip and scaling-list loops of tests/test_tskip.py and
tests/test_scaling_lists.py (both writers with use_tpu_residual off,
and the device residual on and off), and the use_native = False encodes
of tests/test_noise_reduction.py, test_weightp.py, test_rdoq.py and
test_tmvp.py. Every port stream equals the JAX package's for the same
switches. Under noise reduction the two writers' statistics differ on
intra TBs (the Python writer denoises inter TBs only); with this clip's
intra offsets still zero the bytes agree all the same (ROADMAP Queue 3,
tests/test_torch_e2e_tskip.py)."""
import numpy as np
import pytest

from torch_port_util import switch_streams

NATIVE_CPU = {"use_tpu_residual": False}
ORACLE = {"use_native": False, "use_tpu_residual": False}


def _medium_96x64(**kw):
    """The medium-preset base of the JAX tests at 96x64: fixed mini-GOPs,
    no scene cut, no AQ or cuTree, QP 30."""
    def build(mod, kw=kw):
        kw = dict(kw)
        p = mod.param_default_preset("medium")
        p.bframes = kw.pop("bframes", 0)
        p.b_adapt = 0
        p.scenecut = 0
        p.aq_mode = 0
        p.cu_tree = False
        p.sao = kw.pop("sao", False)
        mod.param_parse(p, "qp", "30")
        for name, val in kw.pop("parse", ()):
            mod.param_parse(p, name, val)
        for k, v in kw.items():
            setattr(p, k, v)
        return p
    return build


def _screen_frames(n, seed=3, h=64, w=96):
    """tests/test_tskip.py's screen-content-like frames."""
    rng = np.random.default_rng(seed)
    out = []
    base = np.zeros((h, w), np.uint8)
    base[::8, :] = 250
    base[:, ::16] = 10
    base[20:30, 30:60] = 128
    for i in range(n):
        y = np.roll(base, i * 3, axis=1).copy()
        y[40:50, 10:40] = rng.integers(0, 255, (10, 30))
        out.append((y, np.roll(base, i)[::2, ::2].copy(),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _shift_frames(n, seed=11, h=64, w=96):
    """tests/test_scaling_lists.py's frames."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + h, i * 2:i * 2 + w]),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


@pytest.mark.parametrize("tool", ["tskip", "scaling-list"])
def test_native_matches_oracle_and_device_residual(tool):
    """The writers agree with the device residual off (3 frames), and the
    device residual changes nothing (4 frames)."""
    opt = ("tskip", "1") if tool == "tskip" else ("scaling-list", "default")
    frames = (_screen_frames if tool == "tskip" else _shift_frames)(4)
    build = _medium_96x64(bframes=1, rdoq_level=2, parse=[opt])
    nat, py, jpy = switch_streams(build, frames[:3], [
        ("torch", NATIVE_CPU), ("torch", ORACLE), ("jax", ORACLE)])
    assert nat == py == jpy
    on, off = switch_streams(build, frames, [("torch", {}),
                                             ("torch", NATIVE_CPU)])
    assert on == off


def _noisy_clip(n=4, w=96, h=64, seed=6):
    """tests/test_noise_reduction.py's clip."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 210, (h, w)).astype(np.int32)
    return [(np.clip(base + rng.integers(-18, 18, (h, w)), 0, 255)
             .astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for _ in range(n)]


def _fade_clip(w=96, h=64, n=3, seed=3):
    """tests/test_weightp.py's fade."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 200, (h, w)) * 0.3 +
            np.mgrid[0:h, 0:w][1] * 0.9).astype(np.float64)
    cbb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    crb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    frames = []
    for i in range(n):
        g = 1.0 - 0.16 * i
        frames.append((np.clip(base * g, 0, 255).astype(np.uint8),
                       np.clip((cbb - 128) * g + 128, 0, 255)
                       .astype(np.uint8),
                       np.clip((crb - 128) * g + 128, 0, 255)
                       .astype(np.uint8)))
    return frames


def _rdoq_clip(n=4, seed=5):
    """tests/test_rdoq.py's clip (176x144)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:144, 0:176]
    base = (128 + 70 * np.sin(xx / 13.0) * np.cos(yy / 11.0)).astype(int)
    return [(np.clip(np.roll(base, 2 * i, 1) +
                     rng.integers(-6, 6, (144, 176)), 0, 255)
             .astype(np.uint8),
             np.full((72, 88), 120, np.uint8),
             np.full((72, 88), 130, np.uint8)) for i in range(n)]


def _pan_clip(n=5, w=96, h=64, seed=4):
    """tests/test_tmvp.py's pan."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    return [(np.clip(np.roll(base, i * 3, axis=1)
                     + rng.integers(-5, 5, (h, w)), 0, 255).astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


def _slow_rdoq(mod):
    p = mod.param_default_preset("slow")        # rdoq-level 2
    p.qp, p.rc_mode, p.bframes = 30, mod.RC_CQP, 2
    return p


@pytest.mark.parametrize("case", ["nr", "weightp", "tmvp"])
def test_python_writer_encodes_match(case):
    """tests/test_noise_reduction.py:46, test_weightp.py:85,
    test_tmvp.py:88: the Python writer's stream equals the native
    writer's (with the device residual, as the JAX tests run it) and the
    JAX package's Python writer's."""
    build, frames = {
        "nr": (_medium_96x64(nr_intra=500, nr_inter=500), _noisy_clip()),
        "weightp": (_medium_96x64(weightp=True), _fade_clip()),
        "tmvp": (_medium_96x64(bframes=2, b_pyramid=False, tmvp=True),
                 _pan_clip()),
    }[case]
    nat, py, jpy = switch_streams(build, frames, [
        ("torch", {}), ("torch", {"use_native": False}),
        ("jax", {"use_native": False})])
    assert nat == py == jpy


def test_python_writer_slow_rdoq_matches():
    """tests/test_rdoq.py:66 (x265's slow preset: RDOQ 2, rd 4, the
    explicit inter RQT under tu-inter-depth 2). The Python writer's stream
    equals the JAX package's and the native walk's own quantization's.
    With the device residual the P picture differs from both, in both
    packages alike: the device decides the inter RQT split and the
    writers' own walk decides another (ROADMAP Queue 3; the JAX test
    fails on the reference and is marked slow, so no tier-1 run shows
    it). The device stream is the JAX package's (golden case slow_crf,
    tests/test_torch_e2e_slow.py). With tu-inter-depth 1 the device
    residual gives the same bytes (tests/test_torch_finalizer_split.py)."""
    dev, cpu, py, jpy = switch_streams(_slow_rdoq, _rdoq_clip(), [
        ("torch", {}), ("torch", NATIVE_CPU),
        ("torch", {"use_native": False}), ("jax", {"use_native": False})])
    assert py == jpy == cpu
    assert dev != py
