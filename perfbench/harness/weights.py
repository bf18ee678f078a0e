"""Weights for a dense decoder, made on the device from the seed in a few
large calls: one ``normal_`` over a single flat float32 buffer, one
in-place scale for each group of leaves that share an initial scale,
and one fill of ones for the norm scales. Every leaf is a contiguous view
of the buffer, laid out in the program's params layout (a nested dict:
``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V), ``layers``, each with
``attn_norm``, ``attn`` {wq, wk, wv, wo} stored (d_in, d_out), ``ffn_norm``
and ``ffn`` {w_up, w_gate, w_down}). The scales are the program's
initialiser's: 0.02 for the embedding and the head, 1/sqrt(d_in) for
every projection.

The benchmark hands the same tensors to the program and, after the
window, to the plain reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple, Tuple[int, ...], float]  # (path, shape, scale; 0 = ones)


def leaves(cfg: Dict) -> List[Leaf]:
    """Every leaf of the params with its path, shape and initial scale."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    f, V = cfg["d_ff"], cfg["vocab_size"]
    out: List[Leaf] = [(("embed",), (V, d), 0.02),
                       (("lm_head",), (d, V), 0.02),
                       (("final_norm", "scale"), (d,), 0.0)]
    for i in range(cfg["n_layers"]):
        L = ("layers", i)
        out += [(L + ("attn_norm", "scale"), (d,), 0.0),
                (L + ("attn", "wq"), (d, H * hd), 1 / math.sqrt(d)),
                (L + ("attn", "wk"), (d, KV * hd), 1 / math.sqrt(d)),
                (L + ("attn", "wv"), (d, KV * hd), 1 / math.sqrt(d)),
                (L + ("attn", "wo"), (H * hd, d), 1 / math.sqrt(H * hd)),
                (L + ("ffn_norm", "scale"), (d,), 0.0),
                (L + ("ffn", "w_up"), (d, f), 1 / math.sqrt(d)),
                (L + ("ffn", "w_gate"), (d, f), 1 / math.sqrt(d)),
                (L + ("ffn", "w_down"), (f, d), 1 / math.sqrt(f))]
    return out


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        if k == "layers":
            node = node.setdefault("layers", [])
            continue
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
            continue
        node = node.setdefault(k, {})
    node[path[-1]] = value


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The params of ``cfg`` (a configuration file's numbers) on
    ``device`` from ``seed``, float32."""
    device = torch.device(device)
    groups: Dict[float, List[Leaf]] = {}
    for leaf in leaves(cfg):
        groups.setdefault(leaf[2], []).append(leaf)
    total = sum(math.prod(s) for _, s, _ in leaves(cfg))
    buf = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    params: Dict = {}
    off = 0
    spans = []
    for scale, members in sorted(groups.items(), key=lambda kv: -kv[0]):
        start = off
        for path, shape, _ in members:
            n = math.prod(shape)
            _put(params, path, buf[off:off + n].view(shape))
            off += n
        spans.append((scale, start, off))
    drawn = max(end for s, _, end in spans if s > 0)
    buf[:drawn].normal_(generator=gen)
    for scale, start, end in spans:
        if scale > 0:
            buf[start:end].mul_(scale)
        else:
            buf[start:end].fill_(1.0)
    return params
