"""Sweep checkpoint/resume (port of `polar_code_tpu/utils/resume.py`).

Each completed Eb/N0 point is recorded in a JSON state file; re-running the
same sweep (matching config) skips completed points.  A config mismatch
starts the state over, so a stale file never mixes runs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional


class SweepState:
    """Per-point durable state for resumable sweeps."""

    def __init__(self, path: Optional[str], config: Dict, *, writer: bool = True) -> None:
        # multi-process: every rank reads the state (the skip decisions must
        # agree, since the chunks hold collectives), only the coordinator
        # writes it
        self.path = Path(path) if path else None
        self.writer = writer
        self.config = config
        self.rows: Dict[str, Dict] = {}
        if self.path and self.path.exists():
            try:
                data = json.loads(self.path.read_text())
            except json.JSONDecodeError:
                data = {}
            if data.get("config") == config:
                self.rows = data.get("rows", {})

    @staticmethod
    def key(point: float) -> str:
        return f"{float(point):.4f}"

    def get(self, point: float) -> Optional[Dict]:
        return self.rows.get(self.key(point))

    def record(self, point: float, row: Dict) -> None:
        self.rows[self.key(point)] = row
        if self.path and self.writer:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps({"config": self.config, "rows": self.rows}))
            tmp.replace(self.path)


__all__ = ["SweepState"]
