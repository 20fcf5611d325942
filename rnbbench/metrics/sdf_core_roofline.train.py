"""sdf_core_roofline.train (%): the SDF core op's least time over its device
time, in training.

Device time: the kernels launched inside the harness's range around
``ops.sdf_core.sdf_value_feat_grad_fused`` and inside its autograd backward
node (``_SDFCoreBackward``). Least time of a step's ``N = B (n_samples +
n_importance)`` points: the larger of the op's multiply-adds, each product
once (``counts.sdf_fwd_macs`` forward + ``counts.sdf_bwd_macs`` backward,
which leaves out the primal slab the backward runs again), at the bf16 peak
and the op's bytes (``counts.sdf_op_bytes``: inputs read once, outputs
written once) at the memory rate. Moves ``train_rays_per_s``.
"""

from rnbbench import counts
from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnb_tpu_torch.ops.sdf_core", "sdf_value_feat_grad_fused",
                    "_SDFCoreBackward")


def read(rec):
    s = rec.device_s(BOUNDARY)
    if s <= 0:
        return None
    m = rec.conf["model"]
    n = rec.conf["train"]["batch_size"] * counts.core_points(rec.conf) * rec.units
    macs = n * (counts.sdf_fwd_macs(m) + counts.sdf_bwd_macs(m))
    least = counts.bound_s(macs, counts.sdf_op_bytes(m, n, backward=True),
                           rec.peak_flops, rec.peak_bytes)
    return 100.0 * least / s
