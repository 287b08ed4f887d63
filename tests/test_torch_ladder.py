"""The ABR ladder (x265_tpu_torch/api/ladder.py) and the recon sinks
(x265_tpu_torch/io/reconplay.py, the CLI's --recon and --recon-play)
against the JAX package: the process shard, the golden two-rendition
ladder (192x128 -> itself and 96x64, medium ABR; streams and stats()
equal to the JAX ladder's committed golden records, each stream decoded
in the port's decoder), ReconPlay's reorder to display order
(tests/test_apps_io.py:115) and display-order Y4M from both CLI sinks
(tests/test_apps_io.py:136)."""
import numpy as np

from x265_tpu_torch.api import ladder as tladder
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.io.reconplay import ReconPlay
from x265_tpu_torch.io.y4m import VideoInfo, Y4MReader, write_y4m
from x265_tpu_torch.utils import testclip
from torch_port_util import assert_golden_record


def test_rendition_sharding():
    from x265_tpu.api import ladder as jladder
    R = tladder.Rendition
    r = [R(192, 128, 600), R(96, 64, 200), R(48, 32, 80)]
    for pc in (1, 2, 3):
        for pi in range(pc):
            assert (tladder.renditions_for_process(r, pi, pc)
                    == jladder.renditions_for_process(r, pi, pc))
    assert tladder.renditions_for_process(r, 1, 2) == [1]


def test_golden_ladder_equals_the_reference():
    got, records, ladder = testclip.golden_ladder(tladder, device="cpu")
    for name, record in records.items():
        assert_golden_record(name, record)       # stream and stats()
    n = testclip.GOLDEN_LADDER_SOURCE[2]
    for name, (w, h, kbps) in testclip.GOLDEN_LADDER.items():
        pics = HEVCDecoder().decode(got[name])
        assert len(pics) == n and pics[0].y.shape == (h, w)
    # the higher-bitrate rendition spends more bits
    assert len(got["ladder_192x128"]) > len(got["ladder_96x64"])
    assert all(e.device.type == "cpu" for e in ladder.encoders.values())


def _mk(v):
    return (np.full((64, 96), v, np.uint8), np.full((32, 48), v, np.uint8),
            np.full((32, 48), v, np.uint8))


def test_reconplay_reorders_to_display_order(tmp_path):
    path = tmp_path / "recon.y4m"
    rp = ReconPlay("pipe:" + str(path), VideoInfo(96, 64, 25, 1))
    for idx in (0, 3, 1, 2, 5, 4, 4):       # encode order, 4 re-encoded
        rp.write_frame(idx, _mk(idx * 10))
    rp.close()
    r = Y4MReader(str(path))
    vals = [int(y[0, 0]) for (y, cb, cr) in r.frames()]
    r.close()
    assert vals == [0, 10, 20, 30, 40, 50]
    # the same bytes as write_y4m of the display-order pictures
    ref = tmp_path / "ref.y4m"
    write_y4m(str(ref), [_mk(i * 10) for i in range(6)],
              VideoInfo(96, 64, 25, 1))
    assert path.read_bytes() == ref.read_bytes()


def test_cli_recon_and_recon_play_display_order(tmp_path):
    from x265_tpu_torch.cli import main
    from x265_tpu_torch.decoder.decoder import decode_file
    frames = testclip.make_clip(96, 64, 6, 3)
    src = tmp_path / "in.y4m"
    write_y4m(str(src), frames, VideoInfo(96, 64, 25, 1))
    out, rec, play = (tmp_path / n for n in ("out.hevc", "rec.y4m",
                                             "play.y4m"))
    assert main(["--input", str(src), "--output", str(out), "--preset",
                 "ultrafast", "--qp", "30", "--bframes", "2", "--b-adapt",
                 "0", "--scenecut", "0", "--recon", str(rec),
                 "--recon-play", "pipe:" + str(play),
                 "--device", "cpu"]) == 0
    dec = sorted(decode_file(str(out)), key=lambda d: d.poc)
    assert rec.read_bytes() == play.read_bytes()
    r = Y4MReader(str(rec))
    got = list(r.frames())
    r.close()
    assert len(got) == len(dec) == 6
    for d, (y, cb, cr) in zip(dec, got):
        assert np.array_equal(d.y, y) and np.array_equal(d.cb, cb)
