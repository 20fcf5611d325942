"""Scalar logging: ``logs/scalars.jsonl`` always, TensorBoard when
tensorboardX is installed (the port's copy of ``rnb_tpu/utils/logging.py``).
One JSON object a line: ``{"step", "time", <key>: value, ...}``, or a
``{"meta": {...}, "time"}`` header record. A logger made with
``enabled=False`` writes nothing (the ranks other than the chief of a
parallel run: one writer is enough, and appends from several processes to
one file would interleave)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self._enabled = enabled
        self._jsonl = self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            self._tb = None

    def meta(self, record: dict) -> None:
        """A non-scalar header record (resolved runtime flags etc.), so the
        stream describes itself."""
        if not self._enabled:
            return
        self._jsonl.write(json.dumps({"meta": record, "time": time.time()}) + "\n")
        self._jsonl.flush()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if not self._enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
