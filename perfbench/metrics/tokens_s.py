"""tokens_s: tokens emitted in the window over its seconds (host clock),
those of requests unfinished at its close included."""


def read(run):
    w = run.window
    return run.tokens_in_window() / (w.end - w.start)
