"""The native writer against the Python oracle writer (Encoder.use_native
= False) through whole encodes, as the JAX package's tests hold them:
the transform-skip and scaling-list loops of tests/test_tskip.py and
tests/test_scaling_lists.py (both writers with use_tpu_residual off,
and the device residual on and off), and the use_native = False encodes
of tests/test_noise_reduction.py, test_weightp.py, test_rdoq.py and
test_tmvp.py. The Python writer's stream is a golden case's
(utils/testclip.GOLDEN_CASES writer_*, its switches in GOLDEN_ATTRS),
held against the JAX package's committed record; every other port
stream is compared with it. Under noise reduction the two writers'
statistics differ on intra TBs (the Python writer denoises inter TBs
only); with this clip's intra offsets still zero the bytes agree all the
same (ROADMAP Queue 3, tests/test_torch_e2e_tskip.py)."""
import pytest

from x265_tpu_torch.utils import testclip
from torch_port_util import golden_encoders, switch_streams

NATIVE_CPU = {"use_tpu_residual": False}


def _golden(name):
    """(Param builder, golden stream, frames) of a golden case."""
    _enc, stream, _recons, _gold, frames = golden_encoders(name)
    return (lambda P: testclip.golden_params(name, P)), stream, frames


@pytest.mark.parametrize("tool", ["tskip", "scaling-list"])
def test_native_matches_oracle_and_device_residual(tool):
    """The writers agree with the device residual off (3 frames), and the
    device residual changes nothing (4 frames)."""
    name = "writer_" + tool.replace("-", "_")
    build, py, frames = _golden(name)
    nat, = switch_streams(build, frames, [NATIVE_CPU])
    assert nat == py
    w, h = testclip.GOLDEN_SIZES[name]
    maker = getattr(testclip, testclip.GOLDEN_CASES[name][3])
    on, off = switch_streams(build, maker(w, h, 4, testclip.GOLDEN_CASES[
        name][4]), [{}, NATIVE_CPU])
    assert on == off


@pytest.mark.parametrize("case", ["nr", "weightp", "tmvp"])
def test_python_writer_encodes_match(case):
    """tests/test_noise_reduction.py:46, test_weightp.py:85,
    test_tmvp.py:88: the Python writer's stream equals the native
    writer's (with the device residual, as the JAX tests run it) and the
    JAX package's Python writer's."""
    build, py, frames = _golden("writer_" + case)
    nat, = switch_streams(build, frames, [{}])
    assert nat == py


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
    build, py, frames = _golden("writer_slow_rdoq")
    dev, cpu = switch_streams(build, frames, [{}, NATIVE_CPU])
    assert py == cpu
    assert dev != py
