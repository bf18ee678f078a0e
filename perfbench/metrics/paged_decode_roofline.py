"""paged_decode_roofline: paged decode attention's least time from shapes
(queries, the live K/V rows and table columns of each decoding row's
context, lengths and output, at the HBM peak; QK and PV at the float32
peak; the larger) over the device time of the ``paged_decode`` kernel
class (unsplit and split-K, with its combine) in the traced window, in
%. Empty slots and the bucket padding ahead of each prompt are no work
the requests need, and are left out."""
from perfbench.counts import attention, peaks


def read(run):
    fw = [f for f in run.traced_forwards() if f["kind"] == "decode"]
    if run.trace is None or not fw:
        return None
    secs = run.class_seconds("paged_decode")
    if secs <= 0:
        return None
    least = sum(peaks.least_seconds(*attention.paged_decode(
        run.cfg, f["real_contexts"], run.block_size)) for f in fw)
    return 100.0 * least / secs
