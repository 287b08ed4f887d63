"""Is the committed golden record still the frozen reference's? Every
golden case (utils/testclip.GOLDEN_CASES) and every rendition of the
golden ladder (GOLDEN_LADDER) is encoded by the JAX package through
testclip.golden_record (testclip.golden_ladder), and its whole record
must equal the committed entry in utils/golden_streams.json, which the
port's tests hold the port against. The JAX encoder's own set-up is held
too: the case's switches (GOLDEN_ATTRS) and its mesh (GOLDEN_MESH).

Marked slow, so the tier-1 run leaves it out. Run it after any change to
testclip.py's cases or clips, to golden_streams.json, or to the
installed jax:

    python -m pytest tests/test_torch_golden_fresh.py -m slow -n 4

`python -m tools.golden_record` writes the entries it holds.
"""
import functools

import pytest

from x265_tpu_torch.utils import testclip
from tools.golden_record import jax_record
from torch_port_util import assert_golden_record

pytestmark = pytest.mark.slow


@functools.lru_cache(maxsize=None)
def _jax_ladder():
    from x265_tpu.api import ladder
    return testclip.golden_ladder(ladder)[1]


@pytest.mark.parametrize("name", [*testclip.GOLDEN_CASES,
                                  *testclip.GOLDEN_LADDER])
def test_committed_record_is_the_reference(name, tmp_path):
    if name in testclip.GOLDEN_LADDER:
        assert_golden_record(name, _jax_ladder()[name])
        return
    _stream, record, enc = jax_record(name, str(tmp_path))
    for attr, value in testclip.GOLDEN_ATTRS.get(name, {}).items():
        assert getattr(enc, attr) == value, attr
    assert (enc.mesh is not None) == (name in testclip.GOLDEN_MESH)
    assert_golden_record(name, record)
