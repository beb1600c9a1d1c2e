"""check.host_syncs: the set's reads of a device value on the host
(host_syncs), a batch of the measured window."""


def read(run):
    if not run.window:
        return None
    return run.counters["host_syncs"] / len(run.window)
