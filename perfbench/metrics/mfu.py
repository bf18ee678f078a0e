"""mfu: the traced window's model operations over its seconds at the
card's float32 peak, in %. Model operations: 2 x the layers' parameters
for every token the requests need forwarded (prompt positions past the
bucket padding, and decoding rows, not empty slots), the head at every
position whose logits are needed (a prompt's last position and each
decoding row), and attention's QK and PV at each query's context,
padding left out."""
from perfbench.counts import model, peaks


def read(run):
    t = run.trace
    fw = run.traced_forwards()
    if t is None or not fw:
        return None
    tokens = head = 0
    for f in fw:
        if f["kind"] == "prefill":
            tokens += f["real"]
            head += int(f["last"])
        else:
            tokens += len(f["contexts_active"])
            head += len(f["contexts_active"])
    ops = model.model_ops(run.cfg, tokens, head, model.sum_pairs(fw))
    return 100.0 * ops / (t.window_s * peaks.FP32_FLOPS)
