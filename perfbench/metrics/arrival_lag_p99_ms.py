"""arrival_lag_p99_ms: how late the load generator submitted: the 99th
percentile over the window's requests of submit time less due time
(host clock). The loop submits between engine steps, so a step in flight
delays the arrivals that fall due during it."""
from perfbench.harness.bench import percentile


def read(run):
    st = run.stamps
    rids = run.window.window_rids
    return percentile([(st.submit[r] - st.due[r]) * 1e3 for r in rids], 99)
