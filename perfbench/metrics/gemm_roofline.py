"""gemm_roofline: the projections' and the head's least time from shapes
(each matrix of each forward at the larger of its operations at the
float32 peak and its bytes at the HBM peak: every weight read once,
activations read and written once) over the device time of the ``gemm``
kernel class in the traced window, in %. Only the rows the requests need
count: a decode forward's decoding rows (not every slot's), a prefill
piece's prompt positions past the bucket padding, and the head on a
prompt's last piece and on each decoding row."""
from perfbench.counts import model


def read(run):
    fw = run.traced_forwards()
    if run.trace is None or not fw:
        return None
    secs = run.class_seconds("gemm")
    if secs <= 0:
        return None
    least = 0.0
    for f in fw:
        if f["kind"] == "prefill":
            rows, head = f["real"], int(f["last"])
        else:
            rows = head = len(f["contexts_active"])
        least += model.gemm_least_seconds(run.cfg, rows, head)
    return 100.0 * least / secs
