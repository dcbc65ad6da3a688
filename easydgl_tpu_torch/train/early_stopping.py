"""Early stopping on validation H100 (reference src/util.py:14-58): a copy
of ``easydgl_tpu.train.early_stopping`` (numpy only).

Faithful semantics: NaN-loss abort (util.py:29-30), patience counting on the
tracked accuracy, and per-metric best-result refresh against the FIRST
epoch's validation metrics (util.py:44-47 — ``best_valid`` is assigned once
and never updated; reproduced as-is), checkpoint save on improvement.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np


class EarlyStopping:
    def __init__(self, model_name: str, patience: int = 10,
                 save_fn: Optional[Callable[[], None]] = None):
        self.model = model_name
        self.patience = patience
        self.save_fn = save_fn
        self.counter = 0
        self.res: Optional[Dict[str, float]] = None
        self.best_valid: Optional[Dict[str, float]] = None
        self.best_acc: Optional[float] = None
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def step(self, loss: float, acc: float, valid: Dict[str, float],
             test: Dict[str, float]) -> bool:
        if np.isnan(loss):
            self.early_stop = True
        elif self.best_loss is None:
            self.best_acc = acc
            self.best_loss = loss
            self.best_valid = dict(valid)
            self.res = dict(test)
            self._save()
        elif acc < self.best_acc:
            self.counter += 1
            logging.info("EarlyStopping %s counter: %d out of %d",
                         self.model, self.counter, self.patience)
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_loss = min(loss, self.best_loss)
            self.best_acc = max(acc, self.best_acc)
            for k in self.res:
                if self.best_valid[k] <= valid[k]:
                    self.res[k] = test[k]
            self.counter = 0
            self._save()
        return self.early_stop

    def _save(self):
        if self.save_fn is not None:
            self.save_fn()

    def summary(self) -> Dict[str, float]:
        logging.info("SUMMARY: %s",
                     {k: f"{v:.5f}" for k, v in (self.res or {}).items()})
        return self.res or {}
