"""idle_between_forwards: the share of the traced window in which the
device idled while the program was inside an engine ``step`` span but
outside its forwards (admission, uploads, readbacks, the engine's
bookkeeping), in %. Gaps count by their midpoints, as in
``idle_in_forward``; the two split ``device_idle`` less the idle the
harness leaves between steps."""
from perfbench.metrics.idle_in_forward import idle_split


def read(run):
    split = idle_split(run)
    if split is None or split[2] <= 0:
        return None
    return 100.0 * split[1] / split[2]
