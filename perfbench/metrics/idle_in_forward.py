"""idle_in_forward: the share of the traced window in which the device
idled while the program was inside a forward (its ``prefill``,
``decode`` or ``verify`` span: the host still enqueuing the forward's
launches), in %. Each idle gap of the device trace counts by its
midpoint against the innermost program span there
(``repro_torch.serving.tracing``), as ``DeviceTrace.idle_by_host`` does
for the harness's spans. None without a device trace, without the
program's spans, or where the recorder dropped spans in the window.

``program_spans`` and ``idle_split`` serve ``idle_between_forwards``
too."""
import bisect

FORWARDS = ("prefill", "decode", "verify")


def program_spans(run):
    """The program's spans that overlap the traced window, or None."""
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.serving import tracing
    except ImportError:  # a program without spans
        return None
    s = run.window.stats
    key = "n_spans_dropped"
    if s.get("trace_start", {}).get(key) != s.get("trace_end", {}).get(key):
        return None
    return [sp for sp in tracing.RECORDER.spans()
            if sp.t1 >= t.t0 and sp.t0 <= t.t1] or None


def idle_split(run):
    """(idle s inside a forward span, idle s inside a ``step`` span but
    outside its forwards, the window's s), or None."""
    spans = program_spans(run)
    if spans is None:
        return None
    levels = []
    for names in (FORWARDS, ("step",)):
        lv = sorted((sp.t0, sp.t1) for sp in spans if sp.name in names)
        levels.append(([a for a, _ in lv], lv))
    t = run.trace
    edges = [t.t0] + [x for ab in t.busy() for x in ab] + [t.t1]
    out = [0.0, 0.0]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        for k, (starts, lv) in enumerate(levels):
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and lv[j][1] >= mid:
                out[k] += b - a
                break
    return out[0], out[1], t.window_s


def read(run):
    split = idle_split(run)
    if split is None or split[2] <= 0:
        return None
    return 100.0 * split[0] / split[2]
