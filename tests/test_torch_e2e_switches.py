"""The numpy intra analysis (Encoder.use_tpu_analysis = False, the CLI's
--no-tpu) at 192x128 (utils/testclip.GOLDEN_CASES, GOLDEN_ATTRS): the
low-latency I/P encode and a B-frame encode, each equal to the JAX
package's stream (its committed golden record) and decoded back to the
recon.
Under keyint 1, Encoder.encode's pipelined all-intra path never reads
the switch (as in the JAX package), while the CLI, which calls
encode_frame, does."""
import os
import subprocess
import sys

import numpy as np

from torch_port_util import assert_decodes_to_recon, golden_encoders
from x265_tpu_torch.utils import testclip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spy(calls):
    """Count the numpy analysis's cost grids and the leaf-B batches."""
    def setup(enc):
        for name in ("_intra_cost_grid", "_precompute_b_batch",
                     "_intra_decisions"):
            orig = getattr(enc, name)

            def run(*a, _f=orig, _n=name, **kw):
                calls[_n] = calls.get(_n, 0) + 1
                return _f(*a, **kw)
            setattr(enc, name, run)
    return setup


def test_notpu_low_latency_golden():
    calls = {}
    enc, stream, recons, gold, frames = golden_encoders(
        "ultrafast_zerolatency_notpu", setup=_spy(calls))
    assert not enc.use_tpu_analysis
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPPP"
    # the I picture's decisions and every P picture's intra side (its
    # decisions and the device bank's cost grid) come from the numpy path
    assert calls == {"_intra_decisions": 5, "_intra_cost_grid": 4}
    assert_decodes_to_recon(stream, recons, len(frames))


def test_notpu_bframes_golden():
    calls = {}
    enc, stream, recons, gold, frames = golden_encoders(
        "fast_crf_notpu", setup=_spy(calls))
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types.count("B") >= 4
    # the leaf-B batch is skipped: every picture analyses on its own
    assert "_precompute_b_batch" not in calls
    assert calls["_intra_cost_grid"] == len(frames) - 1
    assert_decodes_to_recon(stream, recons, len(frames))


def test_notpu_is_ignored_by_the_pipelined_all_intra_path(monkeypatch):
    """Encoder.encode under keyint 1 decides every chunk on the device
    bank whatever use_tpu_analysis says: the stream is the default one's
    (its golden digest), and the numpy analysis never runs."""
    import hashlib
    from x265_tpu_torch.api import params as TP
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.engine import mode_decision

    def never(*a, **kw):
        raise AssertionError("the numpy analysis ran")
    monkeypatch.setattr(mode_decision, "decide_intra_frame", never)
    name = "ultrafast_lossless_allintra"
    enc = Encoder(testclip.golden_params(name, TP), device="cpu")
    enc.use_tpu_analysis = False
    stream, _ = testclip.golden_stream(enc, name, testclip.golden_clip(name))
    assert (hashlib.sha256(stream).hexdigest()
            == testclip.golden_digests()[name]["sha256"])


def _clip_y4m(path, n=3, w=64, h=48, seed=8):
    """tests/test_cli.py's clip."""
    from x265_tpu_torch.io.y4m import VideoInfo, write_y4m
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    frames = [(np.clip(base + rng.integers(-5, 5, (h, w)), 0, 255)
               .astype(np.uint8),
               np.full((h // 2, w // 2), 120, np.uint8),
               np.full((h // 2, w // 2), 130, np.uint8)) for _ in range(n)]
    write_y4m(str(path), frames, VideoInfo(width=w, height=h))
    return frames


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    return r


def test_cli_no_tpu_lossless_roundtrip(tmp_path):
    """tests/test_cli.py's --no-tpu lossless all-intra run through the
    port's CLI: the JAX CLI's stream, decoded to the source. The CLIs
    code each picture through encode_frame, which reads the switch, so
    the stream is not the one without --no-tpu."""
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    clip = tmp_path / "in.y4m"
    frames = _clip_y4m(clip)
    common = ["--input", str(clip), "--preset", "ultrafast", "--lossless",
              "--keyint", "1"]
    out = {}
    for tag, module, extra in (
            ("port", "x265_tpu_torch.cli", ["--no-tpu", "--device", "cpu"]),
            ("jax", "x265_tpu.cli", ["--no-tpu"]),
            ("port_tpu", "x265_tpu_torch.cli", ["--device", "cpu"])):
        path = tmp_path / f"{tag}.hevc"
        r = _cli(module, common + ["--output", str(path)] + extra)
        assert "encoded 3 frames" in r.stderr + r.stdout
        out[tag] = path.read_bytes()
    assert out["port"] == out["jax"]
    assert out["port"] != out["port_tpu"]
    pics = HEVCDecoder().decode(out["port"])
    assert len(pics) == 3
    for pic, f in zip(pics, frames):
        for a, b in zip((pic.y, pic.cb, pic.cr), f):
            assert np.array_equal(a, b.astype(np.int32))
