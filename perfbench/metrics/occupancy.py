"""occupancy: the mean share of slots decoding a real sequence per
decode step over the traced window (the engine's decoding slots at each
decode forward), in %."""


def read(run):
    dec = [f for f in run.traced_forwards() if f["kind"] == "decode"]
    if not dec:
        return None
    return 100.0 * sum(len(f["contexts_active"]) / f["rows"]
                       for f in dec) / len(dec)
