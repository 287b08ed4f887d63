"""--hrd with B frames through both packages' command lines on a Y4M
file built in tmp_path: num_reorder_pics is non-zero, so the pic_timing
SEIs' dpb output delays and the SPS/VPS change. The port's stream and
recon file equal the JAX package's."""
import numpy as np

from x265_tpu_torch.utils.testclip import make_clip
import torch_port_util  # noqa: F401  (one torch thread)


def test_hrd_with_bframes_cli(tmp_path):
    """--hrd on a B-frame encode through each package's CLI: the same
    bytes and the same recon file; one buffering period, a pic_timing SEI
    on every picture."""
    from x265_tpu import cli as jcli
    from x265_tpu_torch import cli as tcli
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    from x265_tpu_torch.hevc.bitstream import (
        split_annexb, strip_emulation_prevention)
    from x265_tpu_torch.hevc.sei import (SEI_BUFFERING_PERIOD,
                                         SEI_PIC_TIMING, parse_sei)
    from x265_tpu_torch.io.y4m import VideoInfo, write_y4m, open_input
    w, h, n = 96, 64, 7
    src = tmp_path / "in.y4m"
    write_y4m(str(src), make_clip(w, h, n, seed=4), VideoInfo(w, h))
    args = ["--input", str(src), "--preset", "medium", "--bitrate", "400",
            "--vbv-maxrate", "400", "--vbv-bufsize", "800", "--hrd",
            "--bframes", "2", "--b-adapt", "0", "--scenecut", "0",
            "--no-sao"]
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        out, rec = tmp_path / f"{name}.hevc", tmp_path / f"{name}.y4m"
        assert mod.main(args + ["--output", str(out), "--recon", str(rec)]
                        + extra) == 0
        outs[name] = (out.read_bytes(), rec.read_bytes())
    assert outs["port"] == outs["jax"]
    bs = outs["port"][0]
    nbp = npt = 0
    for nal in split_annexb(bs):
        if ((nal[0] >> 1) & 0x3F) == 39:
            for pt, _ in parse_sei(strip_emulation_prevention(nal[2:])):
                nbp += pt == SEI_BUFFERING_PERIOD
                npt += pt == SEI_PIC_TIMING
    assert nbp == 1 and npt == n
    pics = HEVCDecoder().decode(bs)
    recon = list(open_input(str(tmp_path / "port.y4m")).frames())
    assert len(pics) == len(recon) == n
    for pic, r in zip(pics, recon):
        assert np.array_equal(np.asarray(pic.y), np.asarray(r[0]))
