"""--dolby-vision-rpu in the port (tests/test_apps_io.py:184 mirrored):
both interchange formats of the RPU file (Annex-B framed NAL 62 units,
and 4-byte big-endian length prefixes), one NAL 62 per access unit at
its end carrying the display picture's payload (B frames: encode order
is not display order), the stream equal to the JAX package's and decoded
by the port's decoder."""
import numpy as np
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.hevc.bitstream import annexb, make_nal, split_annexb
import torch_port_util  # noqa: F401  (one torch thread)

N = 4
PAYLOADS = [bytes([0x10 + i, 0xAA, i]) for i in range(N)]


def _frames(n, seed=7, h=64, w=96):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    return [(np.roll(base, i * 2, axis=1),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


def _rpu_file(tmp_path, fmt):
    path = tmp_path / f"rpu_{fmt}.bin"
    if fmt == "annexb":
        path.write_bytes(b"".join(annexb([make_nal(62, pl)])
                                  for pl in PAYLOADS))
    else:
        path.write_bytes(b"".join(len(pl).to_bytes(4, "big") + pl
                                  for pl in PAYLOADS))
    return str(path)


def _encode(E, P, rpu, **kw):
    p = P.param_default_preset("ultrafast")
    p.width, p.height = 96, 64
    p.bframes = 2
    p.b_adapt = 0
    p.scenecut = 0
    P.param_parse(p, "qp", "30")
    P.param_parse(p, "dolby-vision-rpu", rpu)
    enc = E(p, **kw)
    return enc, enc.encode(_frames(N))


@pytest.mark.parametrize("fmt", ["annexb", "length_prefixed"])
def test_dolby_vision_rpu_passthrough(tmp_path, fmt):
    rpu = _rpu_file(tmp_path, fmt)
    enc, bs = _encode(TEncoder, TP, rpu, device="cpu")
    _jenc, ref = _encode(JEncoder, JP, rpu)
    assert bs == ref
    types = [(n[0] >> 1) & 0x3F for n in split_annexb(bs)]
    # one NAL 62 per access unit, the last unit of it: each slice is
    # followed (after its suffix SEIs, none here) by its picture's RPU
    vcl_at = [i for i, t in enumerate(types) if t < 32]
    assert len(vcl_at) == N and types.count(62) == N
    for i in vcl_at:
        assert types[i + 1] == 62
    # payloads in display order: the AU of POC k carries PAYLOADS[k]
    units = [n for n in split_annexb(bs) if (n[0] >> 1) & 0x3F == 62]
    pocs = [s["poc"] for s in enc.frame_stats]
    assert pocs != sorted(pocs)                 # B frames reorder
    assert [u[2:5] for u in units] == [PAYLOADS[k] for k in pocs]
    pics = HEVCDecoder().decode(bs)
    assert len(pics) == N
