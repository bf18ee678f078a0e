"""itl_p95_ms: the 95th percentile of every inter-token gap whose later
token was emitted in the window, from the engine's on_token stamps (host
clock)."""
from perfbench.harness.bench import percentile


def read(run):
    g = run.itl_gaps()
    return None if not g else percentile([x * 1e3 for x in g], 95)
