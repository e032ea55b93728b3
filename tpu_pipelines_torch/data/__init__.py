"""Host-side input staging: the port's copy of the reference's infeed
helpers (``tpu_pipelines/data/input_pipeline.py``)."""
