"""check.search_fallbacks: bucketed searches the set replayed at full depth
(KernelStats.search_fallbacks), a batch of the measured window.  Each one
is a batch that the pipelined path could not settle."""


def read(run):
    if not run.window:
        return None
    return run.counters["search_fallbacks"] / len(run.window)
