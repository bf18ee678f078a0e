"""step_ms: the traced window's seconds over the engine steps in it
(``n_iters``): the mean time of one iteration, prefill pieces and the
decode forward together (host clock)."""


def read(run):
    steps = run.counter_delta("n_iters")
    if not steps or run.trace is None:
        return None
    return 1e3 * run.trace.window_s / steps
