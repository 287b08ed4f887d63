"""The ABR ladder across two processes (BASELINE.json config 5's shape,
tools/torch_ladder_worker.py on torch.distributed's gloo backend): two CPU
workers share the golden ladder (utils/testclip.GOLDEN_LADDER), rank 0
encoding the 192x128 rendition and rank 1 the 96x64 one, and each
stream's SHA-256 equals its golden digest, the JAX package's
single-process stream (so no JAX runs here). The worker imports neither
jax nor x265_tpu."""
import hashlib
import json
import os
import socket
import subprocess
import sys

from x265_tpu_torch.utils import testclip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_ladder_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_golden_ladder(tmp_path):
    port = _free_port()
    out = tmp_path / "ladder"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--coordinator", f"127.0.0.1:{port}",
         "--procs", "2", "--proc-id", str(rank), "--out", str(out),
         "--ladder", "golden", "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    results = []
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, se.decode(errors="replace")[-2000:]
        results.append(json.loads(so.decode().strip().splitlines()[-1]))
    # round-robin shard: rank r owns rendition r
    assert [sorted(r["renditions"]) for r in results] == [["0"], ["1"]]
    gold = testclip.golden_digests()
    for i, name in enumerate(testclip.GOLDEN_LADDER):
        stream = (out / f"r{i}.hevc").read_bytes()
        assert {"sha256": hashlib.sha256(stream).hexdigest(),
                "bytes": len(stream)} == {
            k: gold[name][k] for k in ("sha256", "bytes")}, name
        assert results[i]["renditions"][str(i)]["bytes"] == len(stream)
