"""txns_per_s: transactions whose verdicts reached the host in the measured
window, over the window's seconds (its last batch's verdicts included)."""


def read(run):
    if not run.window or run.window_s <= 0:
        return None
    return sum(b.txns for b in run.window) / run.window_s
