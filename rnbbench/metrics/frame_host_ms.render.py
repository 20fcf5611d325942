"""frame_host_ms.render (ms): host time a frame outside the card's work, in
novel views: the self time of the program's spans ``render.rays`` (the
camera's rays made on the host and uploaded) and ``render.fetch`` (the
frame's copy to the host and its 8-bit conversion; its child
``render.fetch.wait``, the wait for the card, excluded), from the program's
recorder (``rnb_tpu_torch.utils.trace.summary``), which records exactly
while the harness's profiler runs. Reads nothing where the program has no
recorder or no such spans. Moves ``frame_ms``.
"""

SPANS = ("render.rays", "render.fetch")


def read(rec):
    try:
        from rnb_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()["spans"]
    if not all(n in spans for n in SPANS):
        return None
    return 1e3 * sum(spans[n]["self_s"] for n in SPANS) / rec.units
