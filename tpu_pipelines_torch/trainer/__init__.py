"""Trainer runtime: the FnArgs contract, the train loop, export and load
of serving payloads, and serving-dtype helpers."""

from tpu_pipelines_torch.trainer.fn_args import FnArgs, TrainResult  # noqa: F401
from tpu_pipelines_torch.trainer.train_loop import (  # noqa: F401
    TrainLoopConfig,
    TrainState,
    train_loop,
)
from tpu_pipelines_torch.trainer.export import (  # noqa: F401
    export_model,
    load_exported_model,
    warm_start_init,
)
