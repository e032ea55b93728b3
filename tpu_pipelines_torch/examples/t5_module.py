"""T5 seq2seq user module for port payloads.

``build_model``, ``apply_fn``, ``make_generate_step`` and
``make_decode_fns`` mirror ``examples/t5/t5_trainer_module.py``:

  - ``apply_fn`` is the serving hook for ``:predict``: the teacher-forced
    logits of ``{inputs, targets [, input_mask]}``;
  - ``make_generate_step`` is the ``:generate`` hook: beam search with
    ``beam_size``, ``max_decode_len`` and ``eos_id`` from the payload's
    hyperparameters;
  - ``make_decode_fns`` opts the payload into the continuous-batching
    engine (``serving/generative.py``).

End-of-sequence defaults to the tokenizer's [SEP] (id 3), as in the
reference module: its tokenizer emits "[CLS] ... [SEP]" with [PAD]=0
[UNK]=1 [CLS]=2 [SEP]=3, so trained targets end with 3.  ``run_fn``, which
reads the Examples artifact through ``BatchIterator``, waits for the T5
pipeline twin (``ROADMAP.md`` A15), as the BERT module's does.
"""

from typing import Any, Dict, Optional

import torch

from tpu_pipelines_torch.models.t5 import (
    build_t5_model,
    make_beam_generate,
    make_continuous_decode_fns,
)

EOS_ID = 3


def build_model(hyperparameters):
    return build_t5_model(hyperparameters)


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def _ids(batch, key, device) -> torch.Tensor:
    return torch.as_tensor(batch[key], device=device).long()


def _mask(batch, device) -> Optional[torch.Tensor]:
    if "input_mask" not in batch:
        return None
    return torch.as_tensor(batch["input_mask"], device=device).to(torch.int32)


def apply_fn(model, params, batch):
    """Serving hook: numpy (or tensor) features in, f32 logits [b, l, vocab]
    on the params' device out."""
    device = _device(params)
    features: Dict[str, Any] = {
        "inputs": _ids(batch, "inputs", device),
        "targets": _ids(batch, "targets", device),
        "input_mask": _mask(batch, device),
    }
    return torch.func.functional_call(model, params, (features,))


def make_generate_step(model, hyperparameters):
    """Export hook: beam-search decoding, ``fn(params, batch) -> tokens
    [b, max_decode_len]`` (params stay an argument of every call)."""
    gen = make_beam_generate(
        model,
        beam_size=int(hyperparameters.get("beam_size", 4)),
        max_decode_len=int(hyperparameters.get("max_decode_len", 32)),
        eos_id=int(hyperparameters.get("eos_id", EOS_ID)),
    )

    def fn(params, batch):
        device = _device(params)
        tokens, _score = gen(params, _ids(batch, "inputs", device),
                             _mask(batch, device))
        return tokens

    return fn


def make_decode_fns(model, hyperparameters):
    """Export hook: the continuous-batching decode contract (prefill/step
    and geometry), with the same eos/pad conventions as
    ``make_generate_step``."""
    return make_continuous_decode_fns(
        model,
        max_decode_len=int(hyperparameters.get("max_decode_len", 32)),
        eos_id=int(hyperparameters.get("eos_id", EOS_ID)),
        max_input_len=int(hyperparameters.get("max_input_len", 64)),
    )
