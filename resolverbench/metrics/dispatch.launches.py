"""dispatch.launches: kernel launches the host asked for (the runtime's
launch calls in the profiler trace), a batch of the traced span."""


def read(run):
    if run.trace is None or not run.traced_batches:
        return None
    return run.trace["launches"] / run.traced_batches
