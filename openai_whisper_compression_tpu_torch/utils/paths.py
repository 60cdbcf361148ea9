"""Project path/timestamp management.

Parity with the reference's `ProjectConfig`/`EvaluationConfig`
(`openai_whisper_compression/config.py:7-68`): timestamped results/models/
plots directories under a project root.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass


@dataclass
class ProjectPaths:
    root: str = "."
    run_name: str | None = None

    def __post_init__(self) -> None:
        if self.run_name is None:
            self.run_name = time.strftime("%Y%m%d_%H%M%S")

    def _dir(self, *parts: str) -> str:
        p = os.path.join(self.root, *parts)
        os.makedirs(p, exist_ok=True)
        return p

    @property
    def results_dir(self) -> str:
        return self._dir("results", self.run_name)

    @property
    def models_dir(self) -> str:
        return self._dir("models", self.run_name)

    @property
    def plots_dir(self) -> str:
        return self._dir("plots", self.run_name)

    def result_file(self, name: str) -> str:
        return os.path.join(self.results_dir, name)
