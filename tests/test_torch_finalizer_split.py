"""The finalizer split (tests/test_finalizer_split.py) in the port: with
the device's inter residual (Encoder.use_tpu_residual = True) or with
every TB quantized by the native walk (False), the port's streams are
byte-identical to each other and to the JAX package's (the committed
record of golden case split_<configuration>), in the four configurations
of the JAX test (Main10: tests/test_torch_three_way.py)."""
import pytest

from x265_tpu_torch.utils import testclip
from torch_port_util import golden_encoders, switch_streams


def split_streams(name):
    """(stream without the device residual, golden stream) of a golden
    case: the second held against the committed record."""
    _enc, on, _recons, _gold, frames = golden_encoders(name)
    off, = switch_streams(lambda P: testclip.golden_params(name, P),
                          frames, [{"use_tpu_residual": False}])
    return off, on


@pytest.mark.parametrize("cfg", ["medium", "ippp", "rdoq_ref2",
                                 "nosdh_nodeblock"])
def test_split_streams_identical(cfg):
    off, on = split_streams("split_" + cfg)
    assert off == on, (len(off), len(on), cfg)
