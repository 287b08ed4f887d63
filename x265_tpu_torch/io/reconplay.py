"""ReconPlay: stream reconstructed pictures to an external player.

x265 analog: source/output/reconplay.{h,cpp} — x265's --recon-y4m-exe
spawns a player process and pipes the reconstructed frames to its stdin
as Y4M, in display order, so an operator can watch the encode live.

TPU-native differences: recon planes arrive from the encoder in *encode*
order (the mini-GOP finalizer emits anchors before their leading B
frames), so this class keeps a small POC-indexed reorder buffer and
flushes the longest contiguous display-order prefix after every arrival
— the same job reconplay.cpp's writeCount/queue does with its semaphore,
without the thread (the pipe write is cheap next to a frame encode).
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

from x265_tpu_torch.io.y4m import VideoInfo


class ReconPlay:
    def __init__(self, command: str, info: VideoInfo):
        self.info = info
        self.proc: Optional[subprocess.Popen] = None
        self.file = None
        if command.startswith("pipe:"):        # testing hook: write to file
            self.file = open(command[5:], "wb")
        else:
            self.proc = subprocess.Popen(
                command, shell=True, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self._next_poc = 0
        self._pending: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._dead = False
        csp = "C420p10" if info.bit_depth > 8 else "C420mpeg2"
        hdr = (f"YUV4MPEG2 W{info.width} H{info.height} "
               f"F{info.fps_num}:{info.fps_den} Ip A1:1 {csp}\n")
        self._write(hdr.encode("ascii"))

    def _write(self, data: bytes) -> None:
        if self._dead:
            return
        try:
            if self.file is not None:
                self.file.write(data)
            elif self.proc is not None and self.proc.stdin is not None:
                self.proc.stdin.write(data)
        except (BrokenPipeError, OSError):
            # player quit: stop streaming but let the encode continue
            # (reconplay.cpp does the same via abortFlag)
            self._dead = True

    def write_frame(self, poc: int, planes) -> None:
        """Queue one reconstructed picture; flush in display order.
        A re-encoded picture overwrites its pending entry; writes for
        already-flushed indices are dropped."""
        if poc < self._next_poc:
            return
        self._pending[poc] = tuple(np.asarray(p) for p in planes)
        while self._next_poc in self._pending:
            y, cb, cr = self._pending.pop(self._next_poc)
            dt = np.uint16 if self.info.bit_depth > 8 else np.uint8
            maxv = (1 << self.info.bit_depth) - 1
            self._write(b"FRAME\n")
            for p in (y, cb, cr):
                self._write(np.clip(p, 0, maxv).astype(dt).tobytes())
            self._next_poc += 1

    def close(self) -> None:
        # flush any straggler pictures in POC order even if gaps remain
        for poc in sorted(self._pending):
            y, cb, cr = self._pending[poc]
            dt = np.uint16 if self.info.bit_depth > 8 else np.uint8
            maxv = (1 << self.info.bit_depth) - 1
            self._write(b"FRAME\n")
            for p in (y, cb, cr):
                self._write(np.clip(p, 0, maxv).astype(dt).tobytes())
        self._pending.clear()
        if self.file is not None:
            self.file.close()
        if self.proc is not None:
            try:
                if self.proc.stdin:
                    self.proc.stdin.close()
                self.proc.wait(timeout=5)
            except Exception:
                self.proc.kill()
