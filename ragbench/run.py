"""One run of one cell of the benchmark of ``archi_tpu_torch``.

    python3 -m ragbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's deployment from the seed, warms the shapes its traffic
uses, runs the window, checks the answers against the plain reference and
prints one JSON line last on standard output (the compared numbers, each
beside its limit, are also the last lines on standard error).  With
``--trace 1`` the metrics are the cell's per-layer ones, read from the
harness's spans, the program's counters and a device trace of a slice of
the window.  Needs as many CUDA devices as the cell asks for; there is no
fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules that must not be loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "archi_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's start and the imports too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = T_IMPORT - process_age_s()


def set_env() -> None:
    """Kernel caches in fixed directories inside the checkout; no JAX or
    Flax through a library that would load them by itself."""
    cache = os.path.join(ROOT, ".ragbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def banned_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(BANNED))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _finite(v: float) -> float:
    """A request that never finished makes a latency infinite; JSON has no
    infinity, so it is written as 1e300."""
    return float(v) if math.isfinite(v) else 1e300


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, *, control: bool = False) -> dict:
    """Run the cell and return the result line as a dict (``checks`` last,
    ``readings`` with the control's when asked)."""
    import torch

    from ragbench.runctx import Run
    from ragbench.trace import Tracer

    tmp = tempfile.mkdtemp(prefix="ragbench-")
    try:
        r = Run(cell, int(seed), float(seconds), torch.device(device),
                Tracer(trace, tmp), t_process, tmp, control)
        out = cell.traffic_module().run(r)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    prog = out.readings["program"]
    missing = sorted(set(prog) - set(cell.limits))
    if missing:
        raise KeyError(f"cells/{cell.name}.json has no limit for {missing}")
    checks = {n: {"value": _finite(v), "limit": cell.limits[n]}
              for n, v in prog.items()}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = out.setup_s if m["name"] == "setup_s" \
                else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": _finite(v), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.layer_reader(m["name"]).read(out.layer_data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": out.memory_peak_bytes,
            "power_limit_w": power_limit_w() if dev.type == "cuda" else None,
        },
    }
    d = out.layer_data.tracer.device if trace else None
    if d is not None:
        result["device"]["busy_s"] = d["busy_s"]
        result["device"]["window_s"] = d["window_s"]
        result["breakdown"] = {"device_ops": d["device_ops"],
                               "idle_gaps": d["idle_gaps"]}
    if control:
        result["readings"] = out.readings
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_env()
    import torch

    from ragbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ragbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_PROCESS)
    found = banned_modules()
    if found:
        print(f"ragbench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
