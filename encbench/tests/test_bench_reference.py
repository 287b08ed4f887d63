"""The frozen reference: it decodes what the port writes, imports nothing
of the port, and the import guard compares top-level names whole."""
import subprocess
import sys

import numpy as np
import pytest

from encbench import guard, spec, stream
from encbench.reference.decoder import HEVCDecoder
from x265_tpu_torch.api.encoder import Encoder
from x265_tpu_torch.utils import testclip

W, H = 416, 240


@pytest.fixture(scope="module")
def encoded():
    """The medium configuration's stream of 10 crowd pictures at 416x240,
    written by the port on the CPU, with its reconstructions and the
    bytes of each encode_frame call."""
    p = spec.params(spec._load("configs", "medium_1080p"), W, H)
    p.bitrate = 300
    enc = Encoder(p, device="cpu")
    recon = {}
    enc.recon_sink = lambda i, planes: recon.__setitem__(
        i, tuple(np.asarray(x) for x in planes))
    head = enc.headers()
    pics = list(testclip.clip_crowd1080(W, H, 10, seed=3))
    chunks = [(i, enc.encode_frame(*f)) for i, f in enumerate(pics)]
    chunks.append((len(pics), enc.flush()))
    return head, chunks, recon, pics


def test_frozen_decoder_equals_port_recon(encoded):
    head, chunks, recon, _ = encoded
    pics = HEVCDecoder().decode(head + b"".join(c for _, c in chunks))
    assert len(pics) == len(recon) == 10
    for p in pics:
        assert all(np.array_equal(a, b) for a, b in
                   zip((p.y, p.cb, p.cr), recon[p.poc]))


def test_access_units_and_display_indices(encoded):
    head, chunks, _, pics = encoded
    aus = stream.split_access_units(chunks)
    assert len(aus) == len(pics)
    assert b"".join(a.data for a in aus) == b"".join(c for _, c in chunks)
    reader = stream.HeaderReader(head)
    shown = [reader.read(a)["display"] for a in aus]
    assert sorted(shown) == list(range(len(pics)))
    assert shown[0] == 0 and shown != sorted(shown)      # B pictures


def test_reference_loads_nothing_of_the_port():
    assert guard.reference_imports_port() == []
    code = ("import sys; import encbench.reference.decoder, "
            "encbench.reference.analysis, encbench.reference.metrics; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'x265_tpu_torch', 'x265_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    assert out.strip() == "[]"


def test_guard_compares_top_level_names_whole():
    assert guard.loaded_forbidden({"x265_tpu_torch": 1,
                                   "x265_tpu_torch.api": 1}) == []
    assert guard.loaded_forbidden({"x265_tpu": 1, "jax.numpy": 1,
                                   "jaxlib": 1, "flaxen": 1}) == \
        ["jax.numpy", "jaxlib", "x265_tpu"]


def test_run_loads_no_jax():
    code = ("import sys, encbench.run, x265_tpu_torch.api.encoder; "
            "from encbench import guard; print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    assert out.strip() == "[]"
