"""Operations and bytes of a dense GQA decoder's forwards, from shapes.

Every function takes a configuration file's numbers (``d_model``,
``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab_size``,
``n_layers``) and counts the work the shapes need, whatever implements
it: each input byte read once and each output byte written once, two
operations a multiply-add. float32 throughout (4 bytes an element).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from perfbench.counts.peaks import least_seconds

F32 = 4


def layer_matrices(cfg: Dict) -> Tuple[Tuple[int, int], ...]:
    """(d_in, d_out) of one layer's projections: wq, wk, wv, wo, and the
    gated MLP's w_up, w_gate, w_down."""
    d, H, KV, hd, f = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    return ((d, H * hd), (d, KV * hd), (d, KV * hd), (H * hd, d),
            (d, f), (d, f), (f, d))


def params(cfg: Dict) -> Dict[str, int]:
    """Parameter counts: ``layers`` (every projection of every layer),
    ``embed``, ``lm_head``, ``norms`` and ``total``."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    per_layer = sum(a * b for a, b in layer_matrices(cfg))
    out = {"layers": L * per_layer, "embed": V * d, "lm_head": d * V,
           "norms": (2 * L + 1) * d}
    out["total"] = sum(out.values())
    return out


def weight_bytes(cfg: Dict) -> int:
    return F32 * params(cfg)["total"]


def gemm_least_seconds(cfg: Dict, rows: int, head_rows: int) -> float:
    """The least time of one forward's projections and head: each matrix
    product at the larger of its operations at the float32 peak and its
    bytes (weight once, input and output once) at the HBM peak."""
    mats = [(a, b, rows) for a, b in layer_matrices(cfg)] * cfg["n_layers"]
    mats.append((cfg["d_model"], cfg["vocab_size"], head_rows))
    return sum(least_seconds(2.0 * r * a * b, F32 * (a * b + r * (a + b)))
               for a, b, r in mats)


def attention_ops(cfg: Dict, keys_attended: float) -> float:
    """QK and PV operations of every layer when queries attend
    ``keys_attended`` (query, key) pairs in all: 4 * hd per pair per
    query head."""
    return 4.0 * cfg["head_dim"] * cfg["n_heads"] * cfg["n_layers"] \
        * keys_attended


def causal_pairs(start: int, T: int) -> int:
    """(query, key) pairs of T queries at positions start..start+T-1,
    each attending every key up to its own position."""
    return T * start + T * (T + 1) // 2


def model_ops(cfg: Dict, tokens: int, head_rows: int,
              keys_attended: float) -> float:
    """The model's operations: 2 x the layers' parameters a token, the
    head at ``head_rows`` positions, and attention over
    ``keys_attended`` pairs."""
    p = params(cfg)
    return (2.0 * p["layers"] * tokens + 2.0 * p["lm_head"] * head_rows
            + attention_ops(cfg, keys_attended))


def real_piece(f: Dict) -> Tuple[int, int]:
    """(start, T) of a prefill record's prompt positions, counted from the
    prompt's first token: the bucket padding ahead of it is no work the
    request needs (see ``harness.serve``)."""
    return max(f["start"], f["pad"]) - f["pad"], f["real"]


def sum_pairs(forwards: Iterable[Dict]) -> float:
    """(query, key) pairs over forward records, padding left out: a
    prompt position attends the prompt up to itself, a decoding row its
    real context."""
    total = 0.0
    for f in forwards:
        if f["kind"] == "prefill":
            total += causal_pairs(*real_piece(f))
        else:
            total += sum(f["real_contexts"])
    return total
