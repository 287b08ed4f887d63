"""Device-resident frame planes — the DPB's currency.

FramePlanes keeps the canonical copy of a picture where it was produced
— device for a device-side loop-filter output, host for the native
writer's recon — and materializes the other side lazily. Padded device
variants (the ME search layout and the 80-pel MC reference layout,
reference picyuv.cpp extendPicBorder analog) are derived ON DEVICE and
cached per layout, so a DPB anchor is uploaded and padded once however
many frames reference it.
"""
from __future__ import annotations

import numpy as np
import torch


def pad_dev(a: torch.Tensor, pads, dtype=None) -> torch.Tensor:
    """Edge-pad a device plane (or a stack [..., H, W] of planes) on
    device. pads = (top, bottom, left, right); dtype optionally casts.
    Index-select form: exact for every integer type (no float round
    trip)."""
    pt, pb, pl, pr = pads
    H, W = a.shape[-2:]
    if dtype is not None:
        a = a.to(dtype)
    if not (pt or pb or pl or pr):
        return a.contiguous()
    ry = torch.arange(-pt, H + pb, device=a.device).clamp_(0, H - 1)
    rx = torch.arange(-pl, W + pr, device=a.device).clamp_(0, W - 1)
    return a[..., ry, :][..., rx].contiguous()


def is_planes(x) -> bool:
    """True for a 3-plane picture (tuple/list or FramePlanes)."""
    return (isinstance(x, (tuple, list)) and len(x) == 3) or \
        isinstance(x, FramePlanes)


class FramePlanes:
    """(y, cb, cr) with lazy host/device mirrors and derived paddings.

    Indexing/iteration yields HOST planes (numpy int32); `.dev()` yields
    the unpadded device int16 planes; `.dev_padded(pad)` the 80-pel MC
    layout; `.dev_luma_me(...)` the ME search layout.
    """

    __slots__ = ("_host", "_dev", "bd", "device", "_derived")

    def __init__(self, host=None, dev=None, bd: int = 8, device=None):
        if host is None and dev is None:
            raise ValueError("FramePlanes needs host planes or device planes")
        self._host = tuple(host) if host is not None else None
        self._dev = tuple(dev) if dev is not None else None
        self.bd = bd
        if self._dev is not None:
            device = self._dev[0].device
        if device is None:
            raise ValueError("FramePlanes from host planes needs a device")
        self.device = torch.device(device)
        self._derived = {}

    # --- host side ---
    def host(self):
        if self._host is None:
            self._host = tuple(p.cpu().numpy().astype(np.int32)
                               for p in self._dev)
        return self._host

    @property
    def host_ready(self) -> bool:
        return self._host is not None

    def __getitem__(self, i):
        return self.host()[i]

    def __len__(self):
        return 3

    def __iter__(self):
        return iter(self.host())

    def host_padded(self, pad: int = 80):
        """Host int16 planes in the MC reference layout (luma edge-padded
        by `pad`, chroma by pad//2), for the native writer."""
        key = ("host_mc", pad)
        if key not in self._derived:
            self._derived[key] = tuple(
                np.pad(np.asarray(pl).astype(np.int16),
                       pad >> (0 if i == 0 else 1), mode="edge")
                for i, pl in enumerate(self.host()))
        return self._derived[key]

    def host_decimated4(self):
        """(y, cb, cr)[::4, ::4] on the host, downloaded decimated (the
        weightp moment fit reads only this grid — 1/16 of the bytes)."""
        key = "dec4"
        if key not in self._derived:
            if self._host is not None:
                self._derived[key] = tuple(np.asarray(p)[::4, ::4]
                                           for p in self._host)
            else:
                self._derived[key] = tuple(
                    p[::4, ::4].contiguous().cpu().numpy()
                    for p in self._dev)
        return self._derived[key]

    # --- device side ---
    def dev(self):
        """(y, cb, cr) device planes, int16, unpadded."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(
                    np.asarray(p, np.int16))).to(self.device)
                for p in self._host)
        return self._dev

    def dev_padded(self, pad: int = 80):
        """MC reference layout: luma edge-padded by `pad` on every side,
        chroma by pad//2 (matches api.encoder._pad_ref)."""
        key = ("mc", pad)
        if key not in self._derived:
            y, cb, cr = self.dev()
            hp = pad // 2
            self._derived[key] = (
                pad_dev(y, (pad, pad, pad, pad), torch.int16),
                pad_dev(cb, (hp, hp, hp, hp), torch.int16),
                pad_dev(cr, (hp, hp, hp, hp), torch.int16))
        return self._derived[key]

    def dev_luma_me(self, P: int, ph: int, pw: int):
        """ME search layout: luma padded to (ph, pw) with edge rows, then
        P more on every side, int16."""
        key = ("me", P, ph, pw)
        if key not in self._derived:
            y = self.dev()[0]
            H, W = y.shape
            self._derived[key] = pad_dev(
                y, (P, P + (ph - H), P, P + (pw - W)), torch.int16)
        return self._derived[key]


class MELuma:
    """Luma-only motion-search reference handle backed by a device plane
    (e.g. a weighted reference built on device)."""

    __slots__ = ("_dev", "bd", "device", "_derived")

    def __init__(self, dev, bd: int = 8):
        self._dev = dev
        self.bd = bd
        self.device = dev.device
        self._derived = {}

    def dev_luma_me(self, P: int, ph: int, pw: int):
        key = ("me", P, ph, pw)
        if key not in self._derived:
            H, W = self._dev.shape
            self._derived[key] = pad_dev(
                self._dev, (P, P + (ph - H), P, P + (pw - W)), torch.int16)
        return self._derived[key]
