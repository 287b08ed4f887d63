"""The check fails the faults a cell can have. Each test drives a whole
run but the card (the port's plain PyTorch path on the CPU, 416x240, the
live cell), with the timed path broken underneath, and sees ``correct``
come out false; the first sees a sound run pass."""
import pytest
import torch

from encbench import run, spec
from x265_tpu_torch.api import encoder as E
from x265_tpu_torch.models import intra_frame as IF

CELL = "live_1080p.cuts"


def go(seed=2 ** 31 + 11, seconds=2.0):
    return run.run_cell(CELL, seed, seconds, 0, device="cpu",
                        size=(416, 240), check_pictures=3)


def break_window_call(monkeypatch, at, fault):
    """Apply fault(out, previous) to the window encoder's call number
    `at` (the warm-up's encoder has no recon sink)."""
    orig = E.Encoder.encode_frame
    state = {}

    def encode_frame(self, *a, **k):
        out = orig(self, *a, **k)
        if self.recon_sink is None and id(self) not in state:
            return out
        n = state.setdefault(id(self), [0, b""])
        n[0] += 1
        prev, n[1] = n[1], out
        return fault(out, prev) if n[0] == at else out
    monkeypatch.setattr(E.Encoder, "encode_frame", encode_frame)


def test_sound_run_is_correct():
    r = go()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 3


def test_token_altered_where_produced(monkeypatch):
    def flip(out, _prev):
        b = bytearray(out)
        b[len(b) * 3 // 4] ^= 0x10
        return bytes(b)
    break_window_call(monkeypatch, 2, flip)
    r = go()
    assert not r["correct"] and r["checks"]["recon_mismatch"]["value"] >= 1


def test_step_returns_its_state_unchanged(monkeypatch):
    break_window_call(monkeypatch, 2, lambda out, prev: prev)
    r = go()
    assert not r["correct"] and r["checks"]["unparsed_aus"]["value"] >= 1


def test_half_of_the_blocks_left_out(monkeypatch):
    orig = IF.frame_intra_analysis

    def half(y, *a, **k):
        modes, cost = orig(y, *a, **k)
        n = modes.shape[0] // 2
        modes, cost = modes.clone(), cost.clone()
        modes[n:2 * n] = modes[:n]
        cost[n:2 * n] = cost[:n]
        return modes, cost
    monkeypatch.setattr(IF, "frame_intra_analysis", half)
    r = go()
    assert not r["correct"] and r["checks"]["analysis_gap"]["value"] > \
        r["checks"]["analysis_gap"]["limit"]


@pytest.mark.parametrize("left_out", [False, True])
def test_vbv_reencode_left_out(monkeypatch, left_out):
    """The VBV scaled to the small picture (maxrate 68 kbps, a 68 kbit
    buffer: at 1080p too the buffer is 25 pictures of the rate) holds a
    sound run; with the VBV re-encode left out, the window's cut (its
    fourth picture) overdraws the buffer."""
    load = spec.load_cell

    def scaled(w):
        c = load(w)
        c["config_spec"]["options"].update({"vbv-maxrate": 68,
                                            "vbv-bufsize": 68})
        return c
    monkeypatch.setattr(spec, "load_cell", scaled)
    if left_out:
        monkeypatch.setattr(E.Encoder, "_vbv_reencode",
                            lambda self, au, rebuild: au)
    r = go(seconds=3.0)
    assert r["attempted"] >= 4
    assert r["correct"] is not left_out, r["checks"]
    assert (r["checks"]["vbv_underflows"]["value"] > 0) is left_out


class _TF32:
    """torch, but every matmul rounds its operands to TF32's 10-bit
    mantissa, as the card does with TF32 on."""

    def __getattr__(self, k):
        return getattr(torch, k)

    @staticmethod
    def matmul(a, b):
        def r(x):
            if x.dtype != torch.float32:
                return x
            i = x.contiguous().view(torch.int32)
            return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.matmul(r(a), r(b))


def test_control_lower_precision_fails(monkeypatch):
    monkeypatch.setattr(IF, "torch", _TF32())
    r = go()
    assert not r["correct"] and r["checks"]["analysis_gap"]["value"] > \
        r["checks"]["analysis_gap"]["limit"]
