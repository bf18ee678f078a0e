"""LM trainer: the end-to-end training driver, the port of
``repro.train.trainer`` (``examples_torch/train_small_lm.py`` trains a
~20M or ~100M-param model for a few hundred steps with it).

One step is ``Model.loss`` (``remat=False``, as the reference's trainer
builds it), ``loss.backward()`` through the kernels' autograd Functions,
then ``TrainState.apply_gradients`` with clipped AdamW, the params and
moments updated in place. Runs on ``device`` (the GPU unless the caller
asks for the CPU) in IEEE float32: TF32 stays off, as in every parity
run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import adam, chain_clip, warmup_cosine
from repro_torch.train.train_state import TrainState


@dataclasses.dataclass
class TrainerConfig:
    batch: int = 8
    seq_len: int = 256
    steps: int = 300
    lr: float = 3e-4
    warmup: int = 50
    clip_norm: float = 1.0
    weight_decay: float = 0.01
    log_every: int = 20
    ckpt_path: Optional[str] = None
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig = TrainerConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, remat=False)
        sched = warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.opt = chain_clip(
            adam(sched, weight_decay=tcfg.weight_decay,
                 mask=lambda path: path.split("/")[-1] not in
                 ("scale", "bias")), tcfg.clip_norm)
        params = init_params(cfg, tcfg.seed, device=self.device)
        self.state = TrainState.create(self.trainable(params), self.opt)

    @staticmethod
    def trainable(params):
        """``params`` with every leaf an autograd leaf that requires grad
        (in place; returns ``params``)."""
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params

    def _step(self, state: TrainState, batch: Dict):
        """(new state, loss) after one step on ``batch``; a param the loss
        does not reach gets a zero gradient, as under ``jax.grad``."""
        loss = self.model.loss(state.params, batch)
        loss.backward()

        def take(p):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            return g

        grads = tree_map(take, state.params)
        return state.apply_gradients(grads, self.opt), loss.detach()

    def data(self) -> TokenPipeline:
        return TokenPipeline(self.cfg.vocab_size, self.tcfg.seq_len,
                             self.tcfg.batch, seed=self.tcfg.seed)

    def to_batch(self, raw: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in raw.items()}

    def run(self, log: Callable[[str], None] = print) -> Dict[str, float]:
        pipe = self.data()
        losses = []
        t0 = time.time()
        it: Iterator = iter(pipe)
        for step in range(self.tcfg.steps):
            batch = self.to_batch(next(it))
            self.state, loss = self._step(self.state, batch)
            losses.append(float(loss))
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                tok_s = (self.tcfg.batch * self.tcfg.seq_len
                         * (step + 1)) / (time.time() - t0)
                log(f"step {step:4d} loss {losses[-1]:.4f} "
                    f"({tok_s:,.0f} tok/s)")
        pipe.close()
        if self.tcfg.ckpt_path:
            save_checkpoint(self.tcfg.ckpt_path, self.state.params,
                            {"steps": self.tcfg.steps,
                             "final_loss": losses[-1]})
        return {"first_loss": losses[0], "final_loss": losses[-1],
                "min_loss": min(losses)}
