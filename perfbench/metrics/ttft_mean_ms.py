"""ttft_mean_ms: the mean time to first token over every request due in
the window, each timed from when it was due (host clock); a request
with no first token by the run's end counts at the time the run
stopped waiting."""


def read(run):
    v = run.ttfts_ms()
    return sum(v) / len(v) if v else None
