"""The record tests' writer and data: ``chip_smoke.py``'s tf.Example
encoder and TFRecord writer (the repo's one; packed or unpacked repeated
values, framed with the masked-crc function given), and seeded rows of
every kind the decoder reads."""

import importlib.util
import os

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_records",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "chip_smoke.py"))
_chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_chip_smoke)

encode_example = _chip_smoke.encode_example
frame = _chip_smoke.frame
write_tfrecord = _chip_smoke.write_tfrecord


def example_rows(rng, n, start=0):
    """Seeded rows of every kind the decoder reads: a string, a float, an
    int64 (negative too), a fixed-length float vector and an int pair."""
    out = []
    for i in range(start, start + n):
        out.append({
            "name": [f"row-{i}-{int(rng.integers(1000))}".encode()],
            "fare": np.asarray([rng.normal() * 10], np.float32),
            "count": np.asarray([int(rng.integers(-10**12, 10**12))]),
            "vec": rng.normal(size=3).astype(np.float32),
            "pair": np.asarray([i, -i - 1]),
        })
    return out
