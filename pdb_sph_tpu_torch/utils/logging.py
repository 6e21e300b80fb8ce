"""Structured metrics (JSONL), as `pdb_sph_tpu/utils/logging.py` writes
them. Fields are plain Python values: the runner converts each 0-dim
tensor with float(), int() or bool() before it logs it."""

from __future__ import annotations

import json
import sys
from typing import IO


class MetricsLogger:
    """Writes one JSON object per line; None path -> stdout."""

    def __init__(self, path: str | None = None):
        self._own = path is not None
        self._f: IO[str] = open(path, "a") if path else sys.stdout

    def log(self, **fields) -> None:
        self._f.write(json.dumps(fields, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
