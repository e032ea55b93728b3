"""TensorBoard scalar sink: ``events.out.tfevents.*`` files written by hand.

The reference writes its train and eval scalars through clu's
``SummaryWriter`` (``tpu_pipelines/trainer/train_loop.py``).  The port
cannot: importing ``torch.utils.tensorboard`` (or clu) loads TensorFlow
and JAX.  An event file is simple enough to write directly:

  - TFRecord framing per record: u64le length, u32le masked crc32c of the
    length, the payload, u32le masked crc32c of the payload (the crc of
    ``data/record_io.py``);
  - the first record is ``Event{wall_time, file_version: "brain.Event:2"}``;
  - each scalar is ``Event{wall_time = 1, step = 2, summary = 5}`` with
    ``Summary{value = 1}`` and ``Value{tag = 1, simple_value = 2}``.

TensorBoard reads these as scalar summaries.  :meth:`SummaryWriter.write_scalars`
flushes after every write, as the reference does, so a crash mid-run keeps
the curve written so far.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Mapping, Optional

from tpu_pipelines_torch.data.record_io import _masked_crc32c

FILE_VERSION = b"brain.Event:2"
_counter = 0
_counter_lock = threading.Lock()


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _bytes_field(num: int, body: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(body)) + body


def encode_event(wall_time: float, step: Optional[int] = None, *,
                 scalars: Optional[Mapping[str, float]] = None,
                 file_version: Optional[bytes] = None) -> bytes:
    """One ``Event`` proto: ``wall_time`` (double), ``step`` (int64), and
    either ``file_version`` or a summary of ``scalars``."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", float(wall_time))
    if step is not None:
        out += _varint(2 << 3 | 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version)
    if scalars:
        values = b"".join(
            _bytes_field(1, _bytes_field(1, str(tag).encode("utf-8"))
                         + _varint(2 << 3 | 5) + struct.pack("<f", float(v)))
            for tag, v in scalars.items()
        )
        out += _bytes_field(5, values)
    return out


def frame(payload: bytes) -> bytes:
    """One TFRecord around ``payload``."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", _masked_crc32c(length)) + payload
            + struct.pack("<I", _masked_crc32c(payload)))


class SummaryWriter:
    """Scalars into one new event file under ``logdir``."""

    def __init__(self, logdir: str):
        global _counter
        os.makedirs(logdir, exist_ok=True)
        with _counter_lock:
            _counter += 1
            n = _counter
        now = time.time()
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
            f"{os.getpid()}.{n}",
        )
        self._f = open(self.path, "ab")
        self._f.write(frame(encode_event(now, file_version=FILE_VERSION)))
        self._f.flush()

    def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        """One event holding every scalar of ``scalars`` at ``step``,
        flushed to the file."""
        if not scalars:
            return
        self._f.write(frame(encode_event(time.time(), step, scalars=scalars)))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
