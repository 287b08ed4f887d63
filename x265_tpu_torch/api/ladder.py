"""Multi-rendition ABR ladder (x265 analog: abrEncApp.{h,cpp} —
AbrEncoder + per-rendition PassEncoder/Reader/Scaler threads sharing a
picture ring; SURVEY.md §2.4 P6).

Renditions are independent encoder instances fed from one shared source
through the downscaler (io/scaler.py). On one card they run one after
another for each source picture (the reader/scaler threads collapse into
this loop). `renditions_for_process` gives the static process->rendition
shard, so the same script splits the renditions over several processes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from x265_tpu_torch.api.encoder import Encoder
from x265_tpu_torch.api.params import RC_ABR, param_default_preset
from x265_tpu_torch.io.scaler import scale_frame


@dataclass
class Rendition:
    width: int
    height: int
    bitrate_kbps: int
    preset: str = "medium"


def renditions_for_process(renditions: List[Rendition],
                           process_index: int = 0,
                           process_count: int = 1) -> List[int]:
    """Static rendition->process shard (round-robin, matches the
    NUMA-pool isolation of abrEncApp)."""
    return [i for i in range(len(renditions))
            if i % process_count == process_index]


class AbrLadder:
    """Encode one source into several renditions. device=None means the
    CUDA device (raises when there is none); every rendition's encoder
    and the scaler run there."""

    def __init__(self, src_width: int, src_height: int,
                 renditions: List[Rendition], fps=(25, 1),
                 process_index: int = 0, process_count: int = 1,
                 device=None):
        self.renditions = renditions
        self.device = device
        self.mine = renditions_for_process(renditions, process_index,
                                           process_count)
        self.encoders = {}
        for i in self.mine:
            r = renditions[i]
            p = param_default_preset(r.preset)
            p.width, p.height = r.width, r.height
            p.rc_mode = RC_ABR
            p.bitrate = r.bitrate_kbps
            p.fps_num, p.fps_den = fps
            self.encoders[i] = Encoder(p, device=device)
        self.streams = {i: [self.encoders[i].headers()] for i in self.mine}

    def push(self, frame) -> None:
        """Feed one source frame; scaled + encoded into every rendition
        owned by this process (Reader+Scaler thread analog)."""
        for i in self.mine:
            r = self.renditions[i]
            scaled = scale_frame(frame, r.height, r.width,
                                 device=self.device)
            self.streams[i].append(self.encoders[i].encode_frame(*scaled))

    def finish(self):
        """Flush all renditions; returns {rendition_index: annexb bytes}."""
        out = {}
        for i in self.mine:
            self.streams[i].append(self.encoders[i].flush())
            out[i] = b"".join(self.streams[i])
        return out

    def stats(self):
        return {i: self.encoders[i].get_stats() for i in self.mine}
