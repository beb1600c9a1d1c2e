"""batch_p95_ms: the 95th percentile, over every batch of the window, of
the time from the batch's call into the set to its final verdicts on the
host (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [b.t_done - b.t_call for b in run.window if b.t_done is not None]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
