"""Experiment logging: TensorBoard scalars and images, parquet records.

Port of ``shacira_tpu/utils/logging.py``'s ``ExperimentLogger``.  Each sink
is optional, as in the JAX package: TensorBoard only where
``torch.utils.tensorboard`` imports, the parquet record only where pandas
does (else the records go to ``logs.json``).  The JAX logger's optional
wandb sink is not carried over.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class ExperimentLogger:
    """TensorBoard + parquet logging, each sink skipped when its package is
    missing."""

    def __init__(self, log_dir: str, exp_name: str = 'exp',
                 use_tensorboard: bool = True):
        self.log_dir = log_dir
        self.exp_name = exp_name
        os.makedirs(log_dir, exist_ok=True)
        self.writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.writer = None
        self._records = []

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if self.writer is not None:
            chw = np.transpose(np.clip(img_hwc, 0, 1), (2, 0, 1))
            self.writer.add_image(tag, chw, step)

    def record(self, metrics: Dict):
        """Append an experiment record row (written on close)."""
        self._records.append({'timestamp': time.time(),
                              'exp_name': self.exp_name, **metrics})

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
        if self._records:
            try:
                import pandas as pd
                df = pd.DataFrame(self._records)
                path = os.path.join(self.log_dir, 'logs.parquet')
                if os.path.exists(path):
                    df = pd.concat([pd.read_parquet(path), df])
                df.to_parquet(path, index=False)
            except Exception:
                with open(os.path.join(self.log_dir, 'logs.json'), 'w') as f:
                    json.dump(self._records, f)
