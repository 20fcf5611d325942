"""render_mfu (%): the novel-view frames' share of the card's bf16 dense peak.

A useful ray's forward FLOPs (``counts.render_ray_flops``: the up-sampling
sweeps, the SDF value, feature and gradient, the albedo; the padding of the
last chunk does not count) times the rays of a frame and the frames of the
traced window, over the window's seconds and the peak. Moves ``frame_ms``.
"""

from rnbbench import counts


def read(rec):
    flops = counts.render_ray_flops(rec.conf) * rec.rays_per_unit * rec.units
    return 100.0 * flops / rec.trace.window_s / rec.peak_flops
