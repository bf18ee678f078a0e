"""prefill_pieces_per_step: the engine's power-of-two prefill pieces per
step over the traced window (its counters ``n_prefill_chunks`` and
``n_iters``). Each piece is a forward that sweeps every weight."""


def read(run):
    pieces = run.counter_delta("n_prefill_chunks")
    steps = run.counter_delta("n_iters")
    return None if not steps else pieces / steps
