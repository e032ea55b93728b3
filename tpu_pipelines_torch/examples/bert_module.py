"""BERT classifier user module for port payloads and fine-tuning.

``build_model`` / ``apply_fn`` mirror ``examples/bert/bert_trainer_module.py``:
the serving hook routes the tokenized feature dict into the classifier,
with ``attention_mask = input_ids > 0`` when the request carries none.
``loss_fn``, ``init_params_fn`` and ``adamw`` are the pieces its ``run_fn``
hands to ``train_loop`` (softmax cross-entropy on integer labels plus
accuracy; ``optax.adamw``).  ``run_fn`` itself reads the Examples artifact
through the Parquet data plane and waits for it (``ROADMAP.md`` A4).
"""

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights

LABEL = "label"


def build_model(hyperparameters):
    return build_bert_model(hyperparameters)


def apply_fn(model, params, batch):
    """Serving hook: numpy (or tensor) features in, logits on the params'
    device out."""
    device = next(iter(params.values())).device
    ids = torch.as_tensor(batch["input_ids"], device=device).long()
    mask = batch.get("attention_mask")
    mask = (ids > 0) if mask is None else torch.as_tensor(mask, device=device)
    features = {"input_ids": ids, "attention_mask": mask.to(torch.int32)}
    return torch.func.functional_call(model, params, (features,))


def init_params_fn(
    generator: torch.Generator,
    sample_batch: Dict[str, Any],
    hyperparameters: Optional[Dict[str, Any]] = None,
) -> torch.nn.Module:
    """A BERT classifier with BERT's initialisation drawn from
    ``generator`` (bind ``hyperparameters`` with ``functools.partial``)."""
    return init_bert_weights(build_bert_model(hyperparameters), generator)


def loss_fn(model, batch, generator):
    """Mean softmax cross-entropy of the classifier's logits against the
    integer ``label`` column, and accuracy."""
    features = {k: v for k, v in batch.items() if k != LABEL}
    logits = model(features, generator=generator)
    labels = batch[LABEL].long()
    loss = F.cross_entropy(logits.float(), labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def adamw(learning_rate: float):
    """``optax.adamw(learning_rate)`` as an optimizer factory: the same
    update rule with optax's defaults (betas 0.9/0.999, eps 1e-8, decoupled
    weight decay 1e-4, not torch's 0.01); foreach or plain, never fused."""
    def make(params):
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4, fused=False,
        )
    return make
