"""Stage-2 classifier training (counterpart of
``gfe_mamba_tpu/training/classify_trainer.py``).

One step runs the whole pipeline in the compute dtype: the frozen
generator (eval mode, no gradient), the combiner and the classifier,
then BCE-with-logits on the f32 logit, a per-tensor gradient clip and
Adam over the combiner and classifier only.  A step whose loss or any
gradient is not finite moves neither the parameters nor Adam's moments;
Adam's step count still advances, as optax's integer count does under
the JAX trainer's finite guard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.models.pipeline import GFEMamba
from gfe_mamba_torch.training.metrics import (confusion_counts,
                                              metrics_from_counts)
from gfe_mamba_torch.training.optim import (advance_adam_count_, all_finite,
                                            cast_for_compute,
                                            clip_by_param_norm_,
                                            compute_dtype)
from gfe_mamba_torch.utils.initializers import check_law, init_weights


class ClassifyTrainer:
    """Trains ``model`` (a :class:`GFEMamba`, f32 master weights) in
    place.  ``mixed_precision="bf16"`` runs the loss on a bf16 copy of
    every parameter and of the MRI; ``"none"`` runs it in f32.  Dropout
    masks come from a generator seeded with ``seed``.  ``init`` is the
    init law of step 0 (``utils/initializers.py``): ``"torch"`` keeps the
    weights ``build_gfe_mamba`` drew under that law, ``"flax"`` draws the whole
    model again from ``seed`` under flax's, as the JAX trainer's
    ``init_state`` does; weights loaded afterwards win."""

    def __init__(self, model: GFEMamba, lr: float = 1e-4,
                 grad_clip: float = 1.0, mixed_precision: str = "bf16",
                 device=None, seed: int = 0, init: str = "torch"):
        if check_law(init) == "flax":
            init_weights(model, torch.Generator().manual_seed(seed), "flax")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        model.generator.requires_grad_(False)
        self.trainable = {n: p for n, p in model.named_parameters()
                          if p.requires_grad}
        self.optimizer = torch.optim.Adam(list(self.trainable.values()), lr=lr)
        self.grad_clip = grad_clip
        self.dtype = compute_dtype(mixed_precision)
        self.frozen, self._frozen_key, self._frozen_from = {}, None, None
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        seed_dropout(model, self.rng)
        self.step = 0

    def _inputs(self, *tensors):
        return [t.to(self.device) for t in tensors]

    def _refresh_frozen(self) -> None:
        """The frozen generator's compute-dtype copy, cast again only when
        a generator parameter was replaced or written in place since the
        last cast (``Tensor._version``): weights loaded after construction
        are seen, as the JAX trainer reads them from its state at every
        step, and an unchanged generator costs no cast."""
        named = dict(self.model.generator.named_parameters(
            prefix="generator"))
        key = [(id(p), p._version) for p in named.values()]
        if key != self._frozen_key:
            with torch.no_grad():
                self.frozen = cast_for_compute(named, self.dtype)
            # the sources stay referenced, so their ids are not reused
            self._frozen_key, self._frozen_from = key, named

    def _logits(self, mri, x_cat, x_num) -> torch.Tensor:
        self._refresh_frozen()
        params = {**self.frozen,
                  **cast_for_compute(self.trainable, self.dtype)}
        logits = functional_call(self.model, params,
                                 (mri.to(self.dtype), x_cat, x_num))
        return logits.float().squeeze(-1)

    def train_step(self, mri, x_cat, x_num, labels) -> dict[str, float]:
        """One update; returns ``{"cla_loss", "batch_acc", "skipped"}``."""
        mri, x_cat, x_num, labels = self._inputs(mri, x_cat, x_num, labels)
        labels = labels.float()
        self.model.train()
        logits = self._logits(mri, x_cat, x_num)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        trainable = list(self.trainable.values())
        grads = torch.autograd.grad(loss, trainable, materialize_grads=True)
        ok = all_finite([loss, *grads])
        if ok:
            clip_by_param_norm_(grads, self.grad_clip)
            for p, g in zip(trainable, grads):
                p.grad = g
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        else:
            advance_adam_count_(self.optimizer, trainable)
        self.step += 1
        acc = ((torch.sigmoid(logits) >= 0.5) == (labels >= 0.5)).float()
        return {"cla_loss": float(loss.detach()),
                "batch_acc": float(acc.mean()),
                "skipped": 0.0 if ok else 1.0}

    @torch.no_grad()
    def eval_step(self, mri, x_cat, x_num, labels):
        """Eval forward in the master dtype -> (probabilities, loss,
        confusion counts)."""
        mri, x_cat, x_num, labels = self._inputs(mri, x_cat, x_num, labels)
        self.model.eval()
        logits = self.model(mri, x_cat, x_num).float().squeeze(-1)
        loss = F.binary_cross_entropy_with_logits(logits, labels.float())
        probs = torch.sigmoid(logits)
        return probs, loss, confusion_counts(probs, labels)

    @staticmethod
    def metrics(counts) -> dict[str, float]:
        return {k: float(v)
                for k, v in metrics_from_counts(counts)._asdict().items()}
