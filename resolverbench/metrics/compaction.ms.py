"""compaction.ms: the set's wall time a compaction (KernelStats.compact_s
over compactions; a compaction ends in a host sync), over the measured
window.  Nothing where the window held no compaction."""


def read(run):
    n = run.counters.get("compactions", 0)
    if not n:
        return None
    return 1e3 * run.counters["compact_s"] / n
