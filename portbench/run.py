"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. A cell (`workloads` in BENCHMARK.json) names a config
(portbench/configs/<config>.json: the run config as run, its sizes and
precision), a traffic mix (portbench/traffic/<traffic>.json: the entry it
drives and its parameters) and its chips; the limits of its comparison are
portbench/limits/<cell>.json, and each per-layer metric's reader is
portbench/metrics/<metric>.py. The harness finds all of them by name, so a
new cell, config, mix or metric is new files and entries only.

A run builds the program (`gta_tpu_torch`) from the config with weights and
traffic made on the device from the seed, warms every shape, then with
`--trace 0` measures `--seconds` of the traffic for the cell's end-to-end
metrics, and with `--trace 1` runs `trace_steps` units of it three times,
once timed and twice profiled (portbench/trace.py), for its per-layer
metrics. It then frees the program and compares what the timed
path produced with the plain reference (portbench/check.py). The last line
of standard output is the result as one JSON object; the compared numbers
and their limits are also the last lines of standard error. Without CUDA,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded at the end, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up is counted from here: the process's start, before any import

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"  # fixed directories inside the checkout, so a cell's second run finds its builds
FORBIDDEN = ("jax", "jaxlib", "flax", "gta_tpu")


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, workload: str) -> tuple:
    """(cell, config file, traffic file) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics whose `workloads` list the cell (every
    per-layer entry has the list)."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def reader(name: str):
    """portbench/metrics/<name>.py's `read`."""
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def steady_host() -> None:
    """Load from one thread once set-up is done: the window's host work is
    Python dispatch and single copies, so torch's CPU pool is cut to one
    thread (no idle workers beside the dispatching one), and what set-up
    made is frozen out of the garbage collector's passes."""
    import torch

    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config: dict = None, traffic: dict = None, t0: float = None, ready=None) -> dict:
    """One run of `workload`; `config` and `traffic` replace the cell's
    files (the CPU tests' shrunk copies); `ready()`, where given, runs
    between set-up and the window."""
    import torch

    from portbench import check, drivers
    from portbench.cost import model_flops
    from portbench.trace import Window, breakdown, trace_passes, union_s

    cell, cfg_file, traffic_file = cell_files(bench, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    t0 = T0 if t0 is None else t0
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    drv = drivers.driver(config, traffic, seed, device)
    if ready is not None:
        ready()
    setup_s = time.time() - t0
    print("portbench: set-up s " + " ".join(f"{k} {v - t0:.3f}" for k, v in drv.phases.items()), file=sys.stderr)
    sync = lambda: drivers.sync(drv.device)  # noqa: E731
    if trace:
        steps = traffic["trace_steps"]
        passes = trace_passes(drv.trace_step, steps, sync)
        print("portbench: %d units: unprofiled %.6f s, profiled (CUDA) %.6f s" % (
            steps, passes["timed_s"], passes["window_s"]), file=sys.stderr, flush=True)
        run = {"attempted": 3 * steps, "failed": 0, "metrics": {}}
    else:
        run = drv.window(seconds)
        if len(run.get("latencies_s", ())) >= 2:
            q = statistics.quantiles(run["latencies_s"], n=20)
            print("portbench: call ms min %.3f q1 %.3f median %.3f q3 %.3f p95 %.3f max %.3f" % tuple(
                1e3 * x for x in (min(run["latencies_s"]), q[4], q[9], q[14], q[18], max(run["latencies_s"]))),
                file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    readings, weights = drv.readings(), drv.weights
    drv.close()
    del drv
    lim = check.limits(workload)
    values = {k: v for k, v in check.numbers(config, traffic, weights, readings, seed).items() if k in lim}
    result = {"correct": check.verdict(values, lim) and run["failed"] == 0,
              "attempted": run["attempted"], "failed": run["failed"]}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        w = Window(cell, config, traffic, steps, peak_bytes=peak, flops_per_step=model_flops(config, traffic),
                   **passes)
        metrics = {}
        for m in per_layer(bench, workload):
            v = reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev.update(busy_s=union_s(w.kernels), window_s=w.window_s)
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = breakdown(w)
    else:
        got = dict(run["metrics"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]} for m in end_to_end(bench, workload)}
        result["device"] = dev
    result["check"] = {k: {"value": v, "limit": lim[k]} for k, v in values.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_files(bench, args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), ready=steady_host)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {loaded}; the benchmark measures the port alone", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
