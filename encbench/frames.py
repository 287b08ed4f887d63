"""The one traffic generator. A mix is a data file (``traffic/<mix>.json``)
whose ``content`` names a generator in ``content/<name>.py`` and whose
other keys are that generator's parameters; its ``order`` says how the
encoder is fed from the pool, and its ``loop`` names the feed in
``feeds/<name>.py``. A new kind of content or feed is a new file there,
found by name: no file of the harness needs an edit.

The pool is made once, in set-up, at the configuration's bit depth.
``order``: ``pingpong`` plays it forward then back (no jump becomes a
scene cut), ``cycle`` plays it round (for ``cuts`` the wrap is one more
cut). Everything is numpy on the host: frames reach the encoder as host
planes, as the port's CLI hands them over.
"""
from __future__ import annotations

import importlib


def make_pool(mix: dict, width: int, height: int, seed: int,
              bit_depth: int = 8):
    """The mix's pictures [(y, cb, cr)] in display order of one pass
    through the pool: uint8 planes at 8 bits, uint16 above."""
    gen = importlib.import_module(f"encbench.content.{mix['content']}")
    return gen.make(mix, width, height, int(seed), bit_depth)


def feed(mix: dict):
    """The mix's feed: ``feeds/<loop>.py``'s ``window``."""
    return importlib.import_module(f"encbench.feeds.{mix['loop']}").window


def feed_order(mix: dict, pool_size: int, count: int, start: int = 0):
    """Pool indices of `count` pictures fed one after another, beginning
    at position `start` of the mix's order."""
    if mix["order"] == "pingpong":
        period = max(1, 2 * pool_size - 2)
        pos = [(start + i) % period for i in range(count)]
        return [p if p < pool_size else period - p for p in pos]
    if mix["order"] == "cycle":
        return [(start + i) % pool_size for i in range(count)]
    raise ValueError(f"unknown order {mix['order']!r}")
