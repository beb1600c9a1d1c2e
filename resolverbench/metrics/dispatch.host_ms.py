"""dispatch.host_ms: host wall of the set's sync=False call, a batch, over
the measured window (the traced span is not in it)."""


def read(run):
    if not run.window:
        return None
    return 1e3 * sum(b.t_disp - b.t_call for b in run.window) / len(run.window)
