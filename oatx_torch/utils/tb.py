"""TensorBoard writer (port of oatx/utils/tb.py, the reference's
logger/visualization.py TensorboardWriter): the backend is imported lazily,
every call is a no-op without tensorboard, and set_step logs steps_per_sec."""

from __future__ import annotations

import time
from typing import Optional


class TensorboardWriter:
    def __init__(self, log_dir: Optional[str] = None, enabled: bool = True):
        self._writer = None
        self.step = 0
        self.mode = ""
        self._step_time = time.time()
        if enabled and log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(str(log_dir))
            except Exception:
                try:
                    from tensorboardX import SummaryWriter  # type: ignore

                    self._writer = SummaryWriter(str(log_dir))
                except Exception:
                    self._writer = None

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        self.step = step
        if step == 0:
            self._step_time = time.time()
        else:
            now = time.time()
            dt = now - self._step_time
            if dt > 0:
                self.add_scalar("steps_per_sec", 1.0 / dt)
            self._step_time = now

    def add_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        if self._writer is not None:
            self._writer.add_scalar(f"{self.mode}/{tag}" if self.mode else tag,
                                    float(value), step if step is not None else self.step)

    def add_text(self, tag: str, text: str, step: Optional[int] = None) -> None:
        if self._writer is not None:
            self._writer.add_text(tag, text, step if step is not None else self.step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
