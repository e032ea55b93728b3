"""BERT classifier user module for port payloads.

``build_model`` / ``apply_fn`` mirror ``examples/bert/bert_trainer_module.py``:
the serving hook routes the tokenized feature dict into the classifier,
with ``attention_mask = input_ids > 0`` when the request carries none.
``run_fn`` (fine-tuning) waits for the training slice of the port.
"""

import torch

from tpu_pipelines_torch.models.bert import build_bert_model


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
