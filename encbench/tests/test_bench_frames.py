"""The traffic generator is a function of the seed, and where a mix copies
one of the port's test clips the copy equals the original."""
import numpy as np
import pytest

from encbench import frames, spec
from x265_tpu_torch.utils import testclip

W, H = 416, 240


def same(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(p, q) for p, q in zip(x, y)) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["crowd", "cuts"])
def test_deterministic_by_seed(mix):
    m = dict(spec._load("traffic", mix))
    if mix == "cuts":
        m.update(scene_length=6)
    seed = 2 ** 31 + 12345
    a = frames.make_pool(m, W, H, seed)
    assert same(a, frames.make_pool(m, W, H, seed))
    assert not same(a, frames.make_pool(m, W, H, seed + 1))
    assert all(p.dtype == np.uint8 and p.shape == (H, W) for p, _, _ in a)


@pytest.mark.parametrize("mix", ["crowd", "cuts"])
def test_ten_bit_pool_holds_the_eight_bit_one(mix):
    m = dict(spec._load("traffic", mix))
    if mix == "cuts":
        m.update(scene_length=4)
    a8 = frames.make_pool(m, W, H, 5)
    a10 = frames.make_pool(m, W, H, 5, bit_depth=10)
    assert all(q.dtype == np.uint16
               and np.array_equal(q, p.astype(np.uint16) * 4)
               for x, y in zip(a8, a10) for p, q in zip(x, y))


def test_content_and_feed_are_found_by_name():
    from encbench.feeds import closed
    assert frames.feed({"loop": "closed"}) is closed.window
    with pytest.raises(ModuleNotFoundError):
        frames.make_pool({"content": "no_such_kind"}, W, H, 1)


def test_crowd_is_clip_crowd1080():
    m = spec._load("traffic", "crowd")
    got = frames.make_pool(m, W, H, 40)
    assert same(got, list(testclip.clip_crowd1080(W, H, m["frames"], 40)))


def test_cuts_scene_is_make_cut_clip():
    m = dict(spec._load("traffic", "cuts"), scene_length=8, margin=96)
    got = frames.make_pool(m, W, H, 77)
    assert same(got[:8], testclip.make_cut_clip(W, H, 8, 77, cut=8))
    # the next scene starts again from its own seed
    assert same(got[8:16], testclip.make_cut_clip(W, H, 8, 1077, cut=8))


def test_feed_orders():
    assert frames.feed_order({"order": "pingpong"}, 4, 8) == \
        [0, 1, 2, 3, 2, 1, 0, 1]
    assert frames.feed_order({"order": "cycle"}, 3, 5, start=2) == \
        [2, 0, 1, 2, 0]
