"""Metric logging: `<run_dir>/metrics.jsonl` always, wandb when enabled;
`NullLogger` for the ranks that do not write.

Port of `pharmaforge_tpu/training/logging.py` (reference train.py:86-124):
the same metric names and step cadence, and the run id of a new run
(`generate_run_id`). wandb is imported only when a config enables it.
"""

from __future__ import annotations

import json
import secrets
import string
import time
from pathlib import Path
from typing import Dict, Optional


def generate_run_id(length: int = 8) -> str:
    """A random run id of lowercase letters and digits (the run dir's
    `<name>_<run_id>`)."""
    alphabet = string.ascii_lowercase + string.digits
    return "".join(secrets.choice(alphabet) for _ in range(length))


class NullLogger:
    """The metrics sink of every rank but 0 under data parallelism (JAX
    trainer.py:34-45): it writes nothing."""

    def log(self, metrics: Dict[str, float], step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class MetricsLogger:

    def __init__(self, run_dir: Path, wandb_config: Optional[dict] = None,
                 full_config: Optional[dict] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.run_dir / "metrics.jsonl", "a")
        self._wandb = None
        wandb_config = dict(wandb_config or {})
        mode = wandb_config.pop("mode", "disabled")
        if mode != "disabled":
            import wandb  # only with wandb enabled in the config
            self._wandb = wandb.init(
                project=wandb_config.get("project"),
                group=wandb_config.get("group"),
                name=wandb_config.get("name"), id=wandb_config.get("id"),
                resume=wandb_config.get("resume"),
                dir=str(wandb_config.get("save_dir", self.run_dir)),
                mode=mode, config=full_config)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
