"""The filtered slice as a whole at 192x128: fast + zerolatency (deblock,
SAO, AQ, weightp, 3 refs, 64x64 CTUs) on a clip with a brightness ramp, with
and without AQ: the port's stream equals the JAX package's byte for byte
(its committed golden record) and decodes in the port's decoder to the
encoder's recon. Also the numpy route of the loop filter."""
import pytest

from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.utils import testclip
from torch_port_util import assert_filtered_golden_case


@pytest.mark.parametrize("name", ["fast_zerolatency",
                                  "fast_zerolatency_aq0"])
def test_filtered_stream_byte_identical_and_decodes_to_recon(name):
    assert_filtered_golden_case(name)


def test_numpy_loopfilter_route_gives_the_same_stream():
    """The differential hook: the deblock through hevc/deblock.py on the
    host instead of models/loopfilter.py."""
    name = "fast_zerolatency"
    frames = testclip.golden_clip(name)[:3]
    streams = []
    for dev_route in (True, False):
        enc = TEncoder(testclip.golden_params(name, TP), device="cpu")
        enc.use_tpu_loopfilter = dev_route
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]
