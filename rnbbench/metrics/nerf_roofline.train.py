"""nerf_roofline.train (%): the background NeRF op's least time over its
device time, in training with a background (``n_outside > 0``).

Device time: the kernels launched inside the harness's range around
``ops.nerf.nerf_apply_fused`` and inside its autograd backward node
(``_NeRFBackward``). Least time of a step's ``B (core + n_outside)``
points: the larger of the op's multiply-adds, each product once
(``counts.nerf_macs`` forward + ``counts.nerf_bwd_macs`` backward, which
leaves out the forward the backward runs again), at the bf16 peak and
``counts.nerf_op_bytes`` at the memory rate. Moves ``train_rays_per_s``.
"""

from rnbbench import counts
from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnb_tpu_torch.ops.nerf", "nerf_apply_fused", "_NeRFBackward")


def read(rec):
    s = rec.device_s(BOUNDARY)
    if s <= 0:
        return None
    m = rec.conf["model"]
    n_out = m["neus_renderer"]["n_outside"]
    n = rec.conf["train"]["batch_size"] * (counts.core_points(rec.conf) + n_out) * rec.units
    macs = n * (counts.nerf_macs(m) + counts.nerf_bwd_macs(m))
    least = counts.bound_s(macs, counts.nerf_op_bytes(m, n), rec.peak_flops,
                           rec.peak_bytes)
    return 100.0 * least / s
