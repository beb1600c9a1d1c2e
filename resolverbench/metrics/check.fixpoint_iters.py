"""check.fixpoint_iters: the intra-batch fixpoint's iterations (the set's
fixpoint_iterations(), a replayed batch counting again), a batch of the
measured window."""


def read(run):
    if not run.window:
        return None
    return run.counters["fixpoint_iters"] / len(run.window)
