"""Logging set-up in the reference's format (utils.py:20-33), the config
dump at start-up, and the JSONL metrics sink."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time


def setup_logger(level: int = logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(level)
        handler.setFormatter(logging.Formatter(
            "[%(levelname)s %(asctime)s] %(message)s"))
        root.addHandler(handler)
    return root


def dump_config(cfg) -> None:
    """Log every config field at start-up (reference utils.py:30-33)."""
    for f in dataclasses.fields(cfg):
        logging.info("config[%s]=%s", f.name, getattr(cfg, f.name))


class MetricsLog:
    """Append-only JSONL metrics sink (model_dir/metrics.jsonl): one JSON
    object per train log point and per eval result, with its kind and a
    timestamp, in the JAX package's format."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8", buffering=1)

    def write(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "ts": round(time.time(), 3)}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
