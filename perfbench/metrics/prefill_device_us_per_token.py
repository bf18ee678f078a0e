"""prefill_device_us_per_token: device us a prompt position in the traced
window: the merged busy time of the profiler's kernels that start inside
a program ``prefill`` span's device interval, over those pieces'
positions past the bucket padding (``real``). None without a device
trace, the program's spans, or a real position."""
from perfbench.metrics.decode_device_ms import device_busy


def read(run):
    got = device_busy(run, "prefill")
    if got is None:
        return None
    busy, fw = got
    real = sum(sp.attrs["real"] for sp in fw)
    return 1e6 * busy / real if real else None
