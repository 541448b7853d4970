"""What a traffic generator gets from the harness, and what it returns."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from ragbench.spec import Cell
from ragbench.trace import Tracer


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    t_process: float          # host clock at process start
    tmpdir: str
    control: bool = False     # also read the float8 control (calibration)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def log(self, msg: str) -> None:
        print(f"[ragbench {time.perf_counter() - self.t_process:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_process

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    setup_s: float
    end_to_end: dict            # name -> value (this cell's metrics)
    memory_peak_bytes: int
    readings: dict              # "program" (and "control") -> name -> value
    layer_data: object = None   # what the per-layer readers read
