"""queue_wait_p90_ms: the 90th percentile over the window's requests of
admission (the engine's on_state "prefill", a slot assigned) less due
time (host clock)."""
from perfbench.harness.bench import percentile


def read(run):
    st = run.stamps
    vals = [(st.admit[r] - st.due[r]) * 1e3 for r in run.window.window_rids
            if r in st.admit]
    return percentile(vals, 90)
