"""sdf_core_roofline.render (%): the SDF core op's least time over its device
time, in novel views (forward only).

Device time: the kernels launched inside the harness's range around
``ops.sdf_core.sdf_value_feat_grad_fused`` (no backward runs). Least time
of a frame's points (every chunk, padded, of ``batch_size`` rays at
``n_samples + n_importance`` points): the larger of ``counts.sdf_fwd_macs``
a point at the bf16 peak and ``counts.sdf_op_bytes`` (forward) at the
memory rate. Moves ``frame_ms``.
"""

import math

from rnbbench import counts
from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnb_tpu_torch.ops.sdf_core", "sdf_value_feat_grad_fused")


def read(rec):
    s = rec.device_s(BOUNDARY)
    if s <= 0:
        return None
    m = rec.conf["model"]
    bsz = rec.conf["train"]["batch_size"]
    chunks = math.ceil(rec.rays_per_unit / bsz)
    n = chunks * bsz * counts.core_points(rec.conf) * rec.units
    least = counts.bound_s(n * counts.sdf_fwd_macs(m),
                           counts.sdf_op_bytes(m, n, backward=False),
                           rec.peak_flops, rec.peak_bytes)
    return 100.0 * least / s
