"""mesh_mfu (%): the mesh extraction's share of the card's bf16 dense peak.

The grid's points (``rays_per_unit``: resolution^3) at one SDF-only pass
(``counts.sdf_only_macs``, two FLOPs a multiply-add) times the meshes of
the traced window, over the window's seconds and the peak. Moves
``mesh_s``.
"""

from rnbbench import counts


def read(rec):
    flops = 2.0 * counts.sdf_only_macs(rec.conf["model"]) * rec.rays_per_unit * rec.units
    return 100.0 * flops / rec.trace.window_s / rec.peak_flops
