"""Stage-2 classifier training (counterpart of
``gfe_mamba_tpu/training/classify_trainer.py``).

One step runs the whole pipeline in the compute dtype: the frozen
generator (eval mode, no gradient), the combiner and the classifier,
then BCE-with-logits on the f32 logit, a per-tensor gradient clip and
Adam over the combiner and classifier only.  A step whose loss or any
gradient is not finite moves neither the parameters nor Adam's moments;
Adam's step count still advances, as optax's integer count does under
the JAX trainer's finite guard.

With a ``mesh`` (``parallel/mesh.py``) each rank steps on its own rows of the
global batch.  The gradients are averaged over the data group before the finite
check and the clip, so every rank takes the same skip decision and the same
update; the logged loss and accuracy are the global batch's, and the dropout
masks those of one process over the global batch (``models/dropout.py``).
Parameters that ``parallel/sharding.py`` split over the model group are clipped
by the norm of the whole tensor.  The port's gradients come from
``torch.autograd.grad``, so DDP's reducer hooks would never fire: the
all-reduce is the trainer's own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.func import functional_call

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.models.pipeline import GFEMamba
from gfe_mamba_torch.parallel.collectives import (all_reduce_mean_,
                                                  all_true, mean_over)
from gfe_mamba_torch.parallel.sharding import sharded_state
from gfe_mamba_torch.training.metrics import (confusion_counts,
                                              metrics_from_counts)
from gfe_mamba_torch.training.optim import (advance_adam_count_, all_finite,
                                            cast_for_compute,
                                            clip_by_param_norm_,
                                            compute_dtype)
from gfe_mamba_torch.utils.initializers import check_law, init_weights
from gfe_mamba_torch.utils.profiling import annotate, to_host


class ClassifyTrainer:
    """Trains ``model`` (a :class:`GFEMamba`, f32 master weights) in
    place.  ``mixed_precision="bf16"`` runs the loss on a bf16 copy of
    every parameter and of the MRI; ``"none"`` runs it in f32.  Dropout
    masks come from a generator seeded with ``seed``.  ``init`` is the
    init law of step 0 (``utils/initializers.py``): ``"torch"`` keeps the
    weights ``build_gfe_mamba`` drew under that law, ``"flax"`` draws the whole
    model again from ``seed`` under flax's, as the JAX trainer's
    ``init_state`` does; weights loaded afterwards win.  ``mesh``: the
    process grid of a multi-process run (module docstring); the model's
    parameters must be equal on every rank, and split (if at all) before
    the trainer is built."""

    def __init__(self, model: GFEMamba, lr: float = 1e-4,
                 grad_clip: float = 1.0, mixed_precision: str = "bf16",
                 device=None, seed: int = 0, init: str = "torch",
                 mesh=None):
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
        self.mesh = mesh
        self.data_group = mesh.data_group if mesh is not None else None
        split = sharded_state(model)
        self.splits = {i: split[n][1] for i, n in enumerate(self.trainable)
                       if n in split}
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        seed_dropout(model, self.rng, mesh)
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

    def gradients(self, mri, x_cat, x_num, labels):
        """The loss's gradients of the trainable parameters (in their
        order), averaged over the data group, and ``{"cla_loss",
        "batch_acc"}`` of the global batch; no update."""
        with annotate("gfe.forward"):
            mri, x_cat, x_num, labels = self._inputs(mri, x_cat, x_num,
                                                     labels)
            labels = labels.float()
            self.model.train()
            logits = self._logits(mri, x_cat, x_num)
            loss = F.binary_cross_entropy_with_logits(logits, labels)
            acc = ((torch.sigmoid(logits) >= 0.5) == (labels >= 0.5)
                   ).float().mean()
        with annotate("gfe.backward"):
            grads = list(torch.autograd.grad(
                loss, list(self.trainable.values()), materialize_grads=True))
        all_reduce_mean_(grads, self.data_group)
        loss, acc = mean_over([to_host(loss.detach(), "cla_loss"),
                               to_host(acc, "batch_acc")],
                              self.data_group, self.device)
        return grads, {"cla_loss": loss, "batch_acc": acc}

    def train_step(self, mri, x_cat, x_num, labels) -> dict[str, float]:
        """One update; returns ``{"cla_loss", "batch_acc", "skipped"}``."""
        with annotate("gfe.step", f"ClassifyTrainer step={self.step}"):
            grads, logs = self.gradients(mri, x_cat, x_num, labels)
            trainable = list(self.trainable.values())
            with annotate("gfe.update"):
                ok = math.isfinite(logs["cla_loss"]) and all_finite(grads)
                if self.mesh is not None and self.mesh.model_size > 1:
                    ok = all_true(ok, self.device)
                if ok:
                    clip_by_param_norm_(grads, self.grad_clip, self.splits)
                    for p, g in zip(trainable, grads):
                        p.grad = g
                    self.optimizer.step()
                    self.optimizer.zero_grad(set_to_none=True)
                else:
                    advance_adam_count_(self.optimizer, trainable)
            self.step += 1
        return {**logs, "skipped": 0.0 if ok else 1.0}

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
        return {k: to_host(v, "metrics")
                for k, v in metrics_from_counts(counts)._asdict().items()}
