"""train_mfu (%): the training step's share of the card's bf16 dense peak.

The ``model`` FLOPs of a step (``counts.step_model_flops``: the core
points at 6 SDF and 3 albedo passes, the up-sampling sweeps at one SDF-only
pass, the background at 3 NeRF passes) times the steps of the traced
window, over the window's seconds and the peak. Moves ``train_rays_per_s``.
"""

from rnbbench import counts


def read(rec):
    flops = counts.step_model_flops(rec.conf) * rec.units
    return 100.0 * flops / rec.trace.window_s / rec.peak_flops
