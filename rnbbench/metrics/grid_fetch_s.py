"""grid_fetch_s (s): host seconds a mesh of the grid's fetch, in mesh
cells: the self time of the program's span ``renderer.grid_fetch`` (the
float16 grid's copy to the host and its float32 conversion; its child
``renderer.grid_fetch.wait``, the wait for the grid query, excluded), from
the program's recorder (``rnb_tpu_torch.utils.trace.summary``), which
records exactly while the harness's profiler runs. Reads nothing where the
program has no recorder or no such span. Moves ``mesh_s``.
"""

SPAN = "renderer.grid_fetch"


def read(rec):
    try:
        from rnb_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()["spans"]
    return spans[SPAN]["self_s"] / rec.units if SPAN in spans else None
