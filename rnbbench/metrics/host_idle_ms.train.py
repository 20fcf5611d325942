"""host_idle_ms.train (ms): card idle time a step that the program's own
spans name, in training.

Each idle gap of the traced window is named by the innermost host event of
the main thread open at its start (``harness.reduce_trace``); this is the
sum of the gaps named by one of the program's spans (``rnb::`` ranges,
``rnb_tpu_torch.utils.trace``) over the window's steps. Reads nothing where
the program records no spans. Moves ``train_rays_per_s``.
"""

PREFIX = "rnb::"


def read(rec):
    s = sum(v for k, v in rec.trace.idle_by_host.items() if k.startswith(PREFIX))
    return 1e3 * s / rec.units if s > 0 else None
