"""host_syncs_per_step: the program's blocking host-device transfers
(uploads and token readbacks, its counter ``n_host_syncs``) per engine
step (``n_iters``) over the traced window. None where the program has no
such counter."""


def read(run):
    s = run.window.stats
    a, b = s.get("trace_start", {}), s.get("trace_end", {})
    if "n_host_syncs" not in a or "n_host_syncs" not in b:
        return None
    steps = b["n_iters"] - a["n_iters"]
    return (b["n_host_syncs"] - a["n_host_syncs"]) / steps if steps \
        else None
