"""marching_cubes_s (s): host seconds of the program's marching cubes
(``ops.marching_cubes.extract_geometry``, host C++) a mesh, on the host
clock inside the harness's span around the call. Moves ``mesh_s``.
"""

from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnb_tpu_torch.ops.marching_cubes", "extract_geometry")


def read(rec):
    secs = rec.host_s(BOUNDARY)
    return sum(secs) / len(secs) if secs else None
