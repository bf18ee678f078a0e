"""decode_device_ms: device ms a decode forward in the traced window: the
merged busy time of the profiler's kernels that start inside a program
``decode`` span's device interval, over those spans. Forwards without a
device interval (a step with no anchor) are left out. None without a
device trace or the program's spans.

``device_busy`` serves ``prefill_device_us_per_token`` too."""
import bisect

from perfbench.harness.trace import union
from perfbench.metrics.idle_in_forward import program_spans


def device_busy(run, kind):
    """(merged busy seconds of the kernels inside each ``kind`` span's
    device interval, those spans), or None."""
    spans = program_spans(run)
    if spans is None:
        return None
    fw = [sp for sp in spans if sp.name == kind and sp.dev is not None]
    if not fw:
        return None
    kernels = run.trace.kernels
    starts = [k[1] for k in kernels]
    busy = 0.0
    for sp in fw:
        lo = bisect.bisect_left(starts, sp.dev[0])
        hi = bisect.bisect_right(starts, sp.dev[1])
        busy += sum(b - a for a, b in union(
            [(s, s + d) for _, s, d in kernels[lo:hi]]))
    return busy, fw


def read(run):
    got = device_busy(run, "decode")
    if got is None:
        return None
    busy, fw = got
    return 1e3 * busy / len(fw)
