"""paged_prefill_roofline: paged prefill attention's least time from
shapes (each piece's prompt positions, the K/V rows and table columns up
to its last position, and output at the HBM peak; causal QK and PV at
the float32 peak; the larger) over the device time of the
``paged_prefill`` kernel class in the traced window, in %. Positions are
counted from the prompt's first token: the bucket padding ahead of it is
no work the request needs."""
from perfbench.counts import attention, model, peaks


def read(run):
    fw = [f for f in run.traced_forwards() if f["kind"] == "prefill"]
    if run.trace is None or not fw:
        return None
    secs = run.class_seconds("paged_prefill")
    if secs <= 0:
        return None
    least = sum(peaks.least_seconds(*attention.paged_prefill(
        run.cfg, *model.real_piece(f), run.block_size))
        for f in fw if f["real"])
    return 100.0 * least / secs
