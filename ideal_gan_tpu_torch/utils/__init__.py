"""Infrastructure of the port: config, checkpoints, summaries, timing,
serialization, the preemption guard."""

from .checkpoint import Checkpoint
from .config import Config, parse_flags
from .serialization import (
    load_json,
    load_pickle,
    load_yaml,
    run_parallels,
    save_json,
    save_pickle,
    save_yaml,
)
from .summary import DictSummaryWriter
from .timer import Timer

__all__ = ["Config", "parse_flags", "Checkpoint", "DictSummaryWriter",
           "Timer", "save_json", "load_json", "save_yaml", "load_yaml",
           "save_pickle", "load_pickle", "run_parallels"]
