"""Train a dense LM for a few hundred steps on synthetic Markov data with
the PyTorch port: the end-to-end training driver (loss must drop well
below the uniform floor). Default is the ~20M model; pass ``--full`` for
the ~100M configuration. Runs on the GPU unless ``--device cpu``.

Run:  python examples_torch/train_small_lm.py [--steps 200] [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.common.types import fmt_count, param_count  # noqa: E402
from repro_torch.config.base import ModelConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.full:
        cfg = ModelConfig(
            name="lm-100m", family="dense", n_layers=10, d_model=640,
            n_heads=10, n_kv_heads=10, d_ff=2560, vocab_size=32_000,
            rope="rope", activation="silu", norm="rmsnorm")
    else:
        cfg = ModelConfig(
            name="lm-20m", family="dense", n_layers=6, d_model=384,
            n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=2_048,
            rope="rope", activation="silu", norm="rmsnorm")
    trainer = Trainer(cfg, TrainerConfig(
        batch=args.batch, seq_len=args.seq, steps=args.steps,
        lr=1e-3, warmup=20, ckpt_path=args.ckpt), device=args.device)
    n = param_count(trainer.state.params)
    print(f"model: {cfg.name}, {fmt_count(n)} params")
    stats = trainer.run()
    floor = math.log(cfg.vocab_size)
    print(f"loss {stats['first_loss']:.3f} -> {stats['final_loss']:.3f} "
          f"(uniform floor {floor:.2f}); learned structure: "
          f"{stats['final_loss'] < floor - 1.0}")


if __name__ == "__main__":
    main()
