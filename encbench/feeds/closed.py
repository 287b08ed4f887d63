"""``closed``: the window's closed loop, as the port's CLI feeds a file:
each picture goes to ``encode_frame`` as soon as the previous call has
returned, until the window's seconds have passed (the call that crosses
the deadline is the last)."""
from __future__ import annotations

import time


def window(enc, picture, seconds):
    """Drive `enc` from its first call; `picture(k)` hands over picture k
    of the window as host planes. Returns the calls' outputs [(k, bytes)],
    the host-clock times each call was made and returned, and the
    window's seconds (its start to the return of its last call)."""
    chunks, submit_t, return_t = [], [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        y, cb, cr = picture(k)
        ts = time.perf_counter()
        out = enc.encode_frame(y, cb, cr)
        te = time.perf_counter()
        submit_t.append(ts)
        return_t.append(te)
        chunks.append((k, out))
        k += 1
        if te >= deadline:
            break
    return {"chunks": chunks, "submit_t": submit_t, "return_t": return_t,
            "window_s": te - t0}
