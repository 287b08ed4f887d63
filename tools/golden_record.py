"""Write the golden records (x265_tpu_torch/utils/golden_streams.json)
from the JAX package: every named golden case (testclip.GOLDEN_CASES) is
encoded by x265_tpu through testclip.golden_record, and the golden
ladder's renditions (GOLDEN_LADDER) through testclip.golden_ladder; each
entry is written into the file. An entry already in the file must keep
its sha256, bytes and qp_maps: if the reference now gives others, the
tool names the cases and writes nothing. From the root of the repo:

    python -m tools.golden_record [name ...]

No name: every case and the ladder. The cases are encoded in up to four
processes of their own on the CPU (a few GiB each).
tests/test_torch_golden_fresh.py holds the file against the JAX package
through this module's jax_record.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import tempfile

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "x265_tpu_torch", "utils", "golden_streams.json")
KEPT = ("sha256", "bytes", "qp_maps")


def jax_record(name, tmpdir):
    """(stream, entry, encoder) of a golden case encoded by the JAX
    package through testclip.golden_record, its fixture files written
    into tmpdir by the JAX package, a GOLDEN_MESH case under a mesh of
    JAX devices (the CPU's virtual devices: XLA_FLAGS'
    xla_force_host_platform_device_count)."""
    from x265_tpu.api import params as JP
    from x265_tpu.api.encoder import Encoder
    from x265_tpu.engine import lookahead
    from x265_tpu.parallel.tiles import make_tile_mesh
    from x265_tpu_torch.utils import testclip
    enc = Encoder(testclip.golden_params(name, JP, tmpdir, encoder=Encoder))
    mesh = (make_tile_mesh(testclip.GOLDEN_MESH[name])
            if name in testclip.GOLDEN_MESH else None)
    stream, entry = testclip.golden_record(
        enc, name, testclip.golden_clip(name), mesh=mesh,
        lookahead=lookahead)
    return stream, entry, enc


def _record(name):
    """{name: entry} of one golden case, or of the ladder ("ladder")."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    if name == "ladder":
        from x265_tpu.api import ladder
        from x265_tpu_torch.utils import testclip
        return testclip.golden_ladder(ladder)[1]
    with tempfile.TemporaryDirectory() as tmp:
        return {name: jax_record(name, tmp)[1]}


def main(argv=None):
    from x265_tpu_torch.utils import testclip
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    a = ap.parse_args(argv)
    names = a.names or [*testclip.GOLDEN_CASES, *testclip.GOLDEN_LADDER]
    unknown = set(names) - set(testclip.GOLDEN_CASES) - set(
        testclip.GOLDEN_LADDER)
    if unknown:
        ap.error("no golden case " + " ".join(sorted(unknown)))
    jobs = [n for n in names if n in testclip.GOLDEN_CASES]
    if set(names) & set(testclip.GOLDEN_LADDER):
        jobs.append("ladder")
    # The mesh cases need 8 JAX devices on the CPU. Under pytest,
    # tests/conftest.py asks XLA for them; this tool runs outside it, so
    # it asks the same before its workers import jax.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    with concurrent.futures.ProcessPoolExecutor(
            min(4, len(jobs)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        new = {}
        for got in ex.map(_record, jobs):
            new.update(got)
            print(" ".join(sorted(got)), flush=True)
    with open(PATH, encoding="utf-8") as f:
        doc = json.load(f)
    old = doc["streams"]
    moved = [n for n in new if n in old
             and any(old[n].get(k) != new[n][k] for k in KEPT)]
    if moved:
        print("the reference's stream changed: " + " ".join(moved),
              file=sys.stderr)
        return 1
    old.update(new)
    with open(PATH, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
