"""kernels_per_step: device operations (kernels and copies) recorded in
the traced window over the engine steps in it."""


def read(run):
    steps = run.counter_delta("n_iters")
    if run.trace is None or not steps:
        return None
    return len(run.trace.kernels) / steps
