"""kernels.hand_ms: device time of the program's hand-written CUDA kernels
(every __global__ of its csrc), a batch of the traced span."""


def read(run):
    if run.trace is None or not run.traced_batches:
        return None
    return 1e3 * run.trace["hand_s"] / run.traced_batches
