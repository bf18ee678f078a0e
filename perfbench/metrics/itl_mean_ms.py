"""itl_mean_ms: the mean of every inter-token gap whose later token was
emitted in the window, from the engine's on_token stamps (host clock):
the time a streamed token takes, over all the window's decode work."""


def read(run):
    g = run.itl_gaps()
    return None if not g else 1e3 * sum(g) / len(g)
