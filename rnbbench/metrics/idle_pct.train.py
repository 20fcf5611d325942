"""idle_pct.train (%): the share of the traced window in which no kernel,
copy or fill ran on the card, in train cells. Moves the cell's end-to-end
metric.
"""


def read(rec):
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
