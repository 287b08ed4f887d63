"""x265's `slower` preset, golden case `slower_crf` (utils/testclip.
GOLDEN_CASES, 192x128, 10 frames, CRF 28): one mini-GOP of 8 B pictures
with the B-pyramid, subme 4, rd 6 (RDOQ), the lookahead clamped to 32
pictures, at ref 4. The port's stream and QPs equal the JAX package's
(its committed golden record) and the stream
decodes in the port's decoder to the encoder's recon. The preset's own
ref 5 is refused by name: the JAX package's native writer codes at most
4 references a list, and its ref-5 streams do not decode."""
import pytest

from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from torch_port_util import assert_decodes_to_recon, golden_encoders


def test_slower_crf():
    enc, stream, recons, gold, frames = golden_encoders("slower_crf")
    p = enc.param
    assert (p.bframes == 8 and p.ref == 4 and p.sub_me == 4
            and p.rd_level == 6 and p.rdoq_level > 0
            and p.rc_lookahead == 32 and p.b_pyramid)
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == gold["qps"]
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "IP" + "B" * 8
    assert_decodes_to_recon(stream, recons, len(frames))


@pytest.mark.parametrize("preset", ["slower", "veryslow", "placebo"])
def test_presets_with_five_references_are_refused(preset):
    p = TP.param_default_preset(preset)
    p.width, p.height = 64, 64
    assert p.ref == 5
    with pytest.raises(NotImplementedError, match="ref 5"):
        TEncoder(p, device="cpu")
