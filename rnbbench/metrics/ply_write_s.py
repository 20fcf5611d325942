"""ply_write_s (s): host seconds a mesh of the PLY write, in mesh cells: the
time of the program's span ``io.write_ply``, from the program's recorder
(``rnb_tpu_torch.utils.trace.summary``), which records exactly while the
harness's profiler runs. Reads nothing where the program has no recorder or
no such span. Moves ``mesh_s``.
"""

SPAN = "io.write_ply"


def read(rec):
    try:
        from rnb_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()["spans"]
    return spans[SPAN]["total_s"] / rec.units if SPAN in spans else None
