"""kernels.torch_ms: device time of every other kernel (torch's own), a
batch of the traced span."""


def read(run):
    if run.trace is None or not run.traced_batches:
        return None
    return 1e3 * run.trace["torch_s"] / run.traced_batches
