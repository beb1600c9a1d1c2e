"""stage.h2d_ms: device time of host-to-device copies, a batch of the
traced span."""


def read(run):
    if run.trace is None or not run.traced_batches:
        return None
    return 1e3 * run.trace["h2d_s"] / run.traced_batches
