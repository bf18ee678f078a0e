"""ttft_p90_ms: the 90th percentile of time to first token over every
request due in the window, each timed from when it was due (host clock).
A request that got no first token by the run's end counts at the time
the run stopped waiting."""
from perfbench.harness.bench import percentile


def read(run):
    return percentile(run.ttfts_ms(), 90)
