"""upsample_ms.render (ms): device time a frame of the renderer's no-grad
up-sampling (``renderer.upsampled_z_vals``), the kernels launched inside the
harness's range around the call. Moves ``frame_ms``.
"""

from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnb_tpu_torch.models.renderer", "upsampled_z_vals")


def read(rec):
    s = rec.device_s(BOUNDARY)
    return 1e3 * s / rec.units if s > 0 else None
