"""Metric logging: the port's copy of the JAX package's `utils/logging.py`.

`MetricLogger` writes one JSON line a `log` call (a step count, the seconds
since it was made, and the metrics as floats), flushed every 100 lines and
at `close`, and prints every `print_every`-th record; `export_curves` saves
a Trainer's ELBO, ELL and KL curves to an `.npz` file.
"""

from __future__ import annotations

import json
import time

import numpy as np


class MetricLogger:
    def __init__(self, path: str | None = None, print_every: int = 0):
        self.path = path
        self.print_every = print_every
        self._n = 0
        self._t0 = time.time()
        self._fh = open(path, "a") if path else None

    def log(self, **metrics):
        self._n += 1
        rec = {"step": self._n, "t": round(time.time() - self._t0, 4)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            if self._n % 100 == 0:
                self._fh.flush()
        if self.print_every and self._n % self.print_every == 0:
            print(rec)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()


def export_curves(trainer, path: str):
    """Save the Trainer's ELBO, ELL and KL curves to `path` (.npz)."""
    np.savez(path,
             elbo=np.asarray([float(x) for x in trainer.loss_curve]),
             ell=np.asarray([float(x) for x in trainer.ell_curve]),
             kld=np.asarray([float(x) for x in trainer.kld_curve]))
