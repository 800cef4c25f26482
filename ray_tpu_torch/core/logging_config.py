"""Structured logging configuration (counterpart of ray.LoggingConfig,
python/ray/_private/ray_logging/__init__.py + logging_config.py).

``ray_tpu_torch.init(logging_config=LoggingConfig(encoding="JSON"))`` configures
the driver process AND every worker the session spawns: the config rides
the environment (workers inherit it at spawn — exec or zygote fork alike)
and ``apply_from_env`` runs in worker startup before user code.

JSON encoding emits one object per record with timestamp/level/logger/
message plus the executing task/actor context (the reference's structured
logs carry job/worker/task ids the same way), so log aggregators can join
worker logs against the state API without parsing freeform text.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional, Sequence

_ENV_KEY = "RAY_TPU_LOGGING_CONFIG"
_VALID_ENCODINGS = ("TEXT", "JSON")


@dataclasses.dataclass
class LoggingConfig:
    encoding: str = "TEXT"
    log_level: str = "INFO"
    # Extra standard LogRecord attributes to include in JSON records
    # (e.g. "filename", "lineno", "threadName").
    additional_log_standard_attrs: Sequence[str] = ()

    def __post_init__(self):
        enc = str(self.encoding).upper()
        if enc not in _VALID_ENCODINGS:
            raise ValueError(
                f"encoding must be one of {_VALID_ENCODINGS}, got "
                f"{self.encoding!r}")
        self.encoding = enc
        self.log_level = str(self.log_level).upper()
        # Validate NOW: a bad level must fail at construction in the
        # driver, not crash every worker at startup via apply_from_env.
        if logging.getLevelName(self.log_level) == \
                f"Level {self.log_level}":
            raise ValueError(f"unknown log_level {self.log_level!r}")

    def to_env(self) -> str:
        return json.dumps({
            "encoding": self.encoding,
            "log_level": self.log_level,
            "additional_log_standard_attrs":
                list(self.additional_log_standard_attrs),
        })

    @classmethod
    def from_env(cls, raw: str) -> "LoggingConfig":
        d = json.loads(raw)
        return cls(encoding=d.get("encoding", "TEXT"),
                   log_level=d.get("log_level", "INFO"),
                   additional_log_standard_attrs=tuple(
                       d.get("additional_log_standard_attrs", ())))


class JsonFormatter(logging.Formatter):
    """One JSON object per record, with executing-task context."""

    def __init__(self, extra_attrs: Sequence[str] = ()):
        super().__init__()
        self.extra_attrs = tuple(extra_attrs)
        # Fixed for the process lifetime; resolve once, not per record.
        self._static_ctx = {
            k: v for k, v in (
                ("worker_id", os.environ.get("RAY_TPU_WORKER_ID")),
                ("node_id", os.environ.get("RAY_TPU_NODE_ID")),
            ) if v}

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "asctime": time.strftime(
                "%Y-%m-%d %H:%M:%S", time.localtime(record.created)),
            "levelname": record.levelname,
            "name": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc_text"] = self.formatException(record.exc_info)
        for attr in self.extra_attrs:
            out[attr] = getattr(record, attr, None)
        out.update(self._static_ctx)
        out.update(_task_context_fields())
        return json.dumps(out)


def _task_context_fields() -> dict:
    """Per-record dynamic context: the executing task/actor ids."""
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime_context

        ctx = get_runtime_context()
        fields = {}
        tid = ctx.get_task_id()
        if tid:
            fields["task_id"] = tid
        aid = ctx.get_actor_id()
        if aid:
            fields["actor_id"] = aid
        return fields
    except Exception:
        return {}


def apply(config: LoggingConfig) -> None:
    """Configure the root logger of THIS process per ``config``."""
    root = logging.getLogger()
    root.setLevel(config.log_level)
    if not root.handlers:
        root.addHandler(logging.StreamHandler())
    for h in root.handlers:
        if config.encoding == "JSON":
            h.setFormatter(JsonFormatter(
                config.additional_log_standard_attrs))
        else:
            h.setFormatter(logging.Formatter(
                "%(asctime)s\t%(levelname)s %(name)s -- %(message)s"))


def export_to_env(config: Optional[LoggingConfig]) -> None:
    """Driver side: publish the config so spawned workers inherit it."""
    if config is None:
        os.environ.pop(_ENV_KEY, None)
    else:
        os.environ[_ENV_KEY] = config.to_env()


def apply_from_env() -> Optional[LoggingConfig]:
    """Worker side: apply the session's logging config, if any.  A
    malformed value must never kill the worker — logging is advisory."""
    raw = os.environ.get(_ENV_KEY)
    if not raw:
        return None
    try:
        config = LoggingConfig.from_env(raw)
        apply(config)
    except Exception:
        return None
    return config
