"""Training launcher of the port::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 100 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --batch 8 --seq 256 --steps 20

Runs on the GPU unless ``--device cpu`` (without a GPU it raises instead
of falling back). fp32 with Adam holds about 16 bytes a parameter
(params, grads and two moments) plus activations and the logit chunks:
full-width qwen3-0.6b (0.6 G params, about 10 GB) fits one H100 80GB;
recurrentgemma-2b (2.7 G, about 43 GB) fits at small batches; chatglm3-6b
(6.2 G, about 100 GB) and the larger configs do not, and need
``--reduced`` on one card.
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.config import get_config, get_reduced_config, list_archs
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    return Trainer(cfg, TrainerConfig(
        batch=args.batch, seq_len=args.seq, steps=args.steps, lr=args.lr,
        ckpt_path=args.ckpt), device=args.device)


def main(argv=None) -> Dict[str, float]:
    stats = make_trainer(parse_args(argv)).run()
    print(f"final loss: {stats['final_loss']:.4f}")
    return stats


if __name__ == "__main__":
    main()
