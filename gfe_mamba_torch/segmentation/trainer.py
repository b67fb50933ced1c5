"""Config-driven segmentation trainer (counterpart of
``gfe_mamba_tpu/segmentation/trainer.py``; reference
unet3d/trainer.py:58-404), in f32 as the JAX one runs.

``create_optimizer`` builds the optimizer by name as the JAX package's
does over optax, held to optax's update rules: ``adam`` (``adamw`` with a
weight decay), ``adamw``, ``sgd`` and ``adamax`` are torch's own, which
compute optax's updates; optax's ``rmsprop`` (eps inside the square
root, momentum applied after the learning rate) and ``adagrad``
(accumulators from 0.1, eps 1e-7 inside the square root) are written out
here, since torch's place eps outside and start from 0.

``UNetTrainer``: fit / train / validate, ``ReduceLROnPlateau`` on the
eval score, best tracking, ``last_checkpoint`` / ``best_checkpoint`` and
resume through ``training/checkpoint.py``'s ``Checkpointer``.  Two
quirks of the JAX step are reproduced, not fixed: the plateau scale
``lr_scale`` multiplies the gradients, not the learning rate (under Adam
that barely changes an update), and the BatchNorm statistics the step's
forward moves are thrown away (the running statistics never move in
training).  A checkpoint holds the weights and the two counters, not the
optimizer, as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.segmentation.losses import get_loss_criterion
from gfe_mamba_torch.segmentation.metrics import get_evaluation_metric
from gfe_mamba_torch.training.checkpoint import Checkpointer
from gfe_mamba_torch.utils.profiling import annotate, to_host


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, momentum=momentum)`` at optax's decay 0.9 and
    eps 1e-8: nu = 0.9 nu + 0.1 g^2 from 0; u = -lr g / sqrt(nu + eps);
    with momentum the trace t = u + momentum t is the update."""

    def __init__(self, params, lr: float, momentum: float | None):
        super().__init__(params, dict(lr=lr, decay=0.9, eps=1e-8,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        state["trace"] = torch.zeros_like(p)
                g, nu = p.grad, state["nu"]
                nu.mul_(group["decay"]).add_((1 - group["decay"]) * g * g)
                u = -group["lr"] * (g * torch.rsqrt(nu + group["eps"]))
                if group["momentum"] is not None:
                    u = state["trace"].mul_(group["momentum"]).add_(u)
                p.add_(u)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: s = g^2 + s from 0.1; u = -lr g /
    sqrt(s + 1e-7) where s > 0, else 0."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, init=0.1, eps=1e-7))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(p,
                                                              group["init"])
                s = state["sum_of_squares"].add_(p.grad * p.grad)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                    0.0)
                p.add_(-group["lr"] * (scale * p.grad))


def create_optimizer(optimizer_config: dict, params) -> torch.optim.Optimizer:
    """The optimizer ``optimizer_config`` names over ``params``, with the
    JAX package's defaults: Adam, lr 1e-4, weight decay 0, momentum 0.9,
    betas (0.9, 0.999)."""
    cfg = dict(optimizer_config)
    name = cfg.pop("name", "Adam").lower()
    lr = cfg.pop("learning_rate", cfg.pop("lr", 1e-4))
    wd = cfg.pop("weight_decay", 0.0)
    momentum = cfg.pop("momentum", 0.9)
    betas = tuple(cfg.pop("betas", (0.9, 0.999)))
    params = list(params)
    if name == "adam":
        if wd:
            return torch.optim.AdamW(params, lr, betas, eps=1e-8,
                                     weight_decay=wd)
        return torch.optim.Adam(params, lr, betas, eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr, betas, eps=1e-8, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr, momentum=momentum,
                               nesterov=cfg.pop("nesterov", False))
    if name == "rmsprop":
        return OptaxRMSprop(params, lr, momentum=momentum)
    if name == "adagrad":
        return OptaxAdagrad(params, lr)
    if name == "adamax":
        return torch.optim.Adamax(params, lr, betas, eps=1e-8)
    raise ValueError(f"unsupported optimizer {name!r}")


class ReduceLROnPlateau:
    """LR scale factor tracking eval-score plateaus (torch
    ReduceLROnPlateau semantics, mode 'max' or 'min')."""

    def __init__(self, mode: str = "max", factor: float = 0.5,
                 patience: int = 10):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.best = -np.inf if mode == "max" else np.inf
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, value: float) -> float:
        improved = (value > self.best) if self.mode == "max" \
            else (value < self.best)
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


def _to(batch_value, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(batch_value)).to(device)


class UNetTrainer:
    """fit -> train epochs -> validate every ``validate_after_iters``,
    checkpoint best + last.  The model trains in place on ``device``
    (CUDA unless ``device="cpu"``)."""

    def __init__(self, model: torch.nn.Module, config: dict,
                 checkpoint_dir: str, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.loss_fn = get_loss_criterion(config)
        self.metric_fn = get_evaluation_metric(config)
        trainer_cfg = config.get("trainer", {})
        self.max_num_iterations = trainer_cfg.get("max_num_iterations", 10000)
        self.max_num_epochs = trainer_cfg.get("max_num_epochs", 100)
        self.validate_after_iters = trainer_cfg.get("validate_after_iters",
                                                    100)
        self.log_after_iters = trainer_cfg.get("log_after_iters", 100)
        self.eval_score_higher_is_better = trainer_cfg.get(
            "eval_score_higher_is_better", True)
        self.scheduler = ReduceLROnPlateau(
            mode="max" if self.eval_score_higher_is_better else "min",
            **config.get("lr_scheduler", {}).get("kwargs", {}))
        self.ckpt = Checkpointer(checkpoint_dir)
        self.best_eval_score = (-np.inf if self.eval_score_higher_is_better
                                else np.inf)
        self.num_iterations = 0
        self.num_epochs = 0
        self.optimizer = None
        self.lr_scale = 1.0

    def init_state(self, seed: int) -> None:
        """Move the model (its weights drawn by ``get_model``) to the
        device, and start a fresh optimizer and the dropout generator from
        ``seed``."""
        self.model.to(self.device)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = create_optimizer(self.config.get("optimizer", {}),
                                          self.params)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        seed_dropout(self.model, self.rng)
        self.lr_scale = 1.0

    def train_step(self, raw, label) -> float:
        """One update on a batch; returns the loss."""
        with annotate("gfe.step", f"UNetTrainer step={self.num_iterations}"):
            with annotate("gfe.forward"):
                self.model.train()
                stats = {k: b.clone() for k, b in self.model.named_buffers()}
                logits = self.model(raw)
                loss = self.loss_fn(logits, label)
            with annotate("gfe.backward"):
                grads = torch.autograd.grad(loss, self.params,
                                            materialize_grads=True)
            with annotate("gfe.update"):
                for p, g in zip(self.params, grads):
                    p.grad = g * self.lr_scale
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
                with torch.no_grad():
                    for k, b in self.model.named_buffers():
                        b.copy_(stats[k])
            return to_host(loss.detach(), "loss")

    @torch.no_grad()
    def validate(self, val_loader) -> float:
        self.model.eval()
        scores, n = 0.0, 0
        for batch in val_loader:
            pred = self.model(_to(batch["raw"], self.device))
            scores += to_host(self.metric_fn(pred, _to(batch["label"],
                                                       self.device)),
                              "eval_metric")
            n += 1
        return scores / max(n, 1)

    def _is_best(self, eval_score: float) -> bool:
        better = (eval_score > self.best_eval_score
                  if self.eval_score_higher_is_better
                  else eval_score < self.best_eval_score)
        if better:
            self.best_eval_score = eval_score
        return better

    def fit(self, train_loader, val_loader) -> None:
        """Train until ``max_num_iterations`` or ``max_num_epochs``,
        checkpointing along the way."""
        for epoch in range(self.max_num_epochs):
            self.num_epochs = epoch
            for batch in train_loader:
                loss = self.train_step(_to(batch["raw"], self.device),
                                       _to(batch["label"], self.device))
                self.num_iterations += 1
                if self.num_iterations % self.log_after_iters == 0:
                    print(f"iter {self.num_iterations}: loss={loss:.5f}")
                if self.num_iterations % self.validate_after_iters == 0:
                    eval_score = self.validate(val_loader)
                    self.lr_scale = self.scheduler.step(eval_score)
                    self.save_checkpoint(self._is_best(eval_score))
                if self.num_iterations >= self.max_num_iterations:
                    return

    def save_checkpoint(self, is_best: bool) -> None:
        payload = {"model": self.model.state_dict(),
                   "num_iterations": self.num_iterations,
                   "best_eval_score": float(self.best_eval_score)}
        self.ckpt.save("last_checkpoint", payload)
        if is_best:
            self.ckpt.save("best_checkpoint", payload)

    def resume(self) -> None:
        """The weights and counters of ``last_checkpoint``, if there is
        one."""
        if self.ckpt.exists("last_checkpoint"):
            payload = self.ckpt.restore("last_checkpoint",
                                        map_location=self.device)
            self.model.load_state_dict(payload["model"])
            self.num_iterations = int(payload["num_iterations"])
            self.best_eval_score = float(payload["best_eval_score"])
