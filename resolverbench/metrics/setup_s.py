"""setup_s: from the start of the process to the start of the window:
CUDA, the kernels' build (in a fresh checkout), the key tables, the
history the window starts from and the warm-up."""


def read(run):
    return run.setup_s
