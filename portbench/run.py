#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the CUDA card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`, whose `driver` names the module under
`harness/` that runs it); its limits are `limits/<cell>.json`. With
`--trace 0` the last line of standard output holds the cell's end-to-end
metrics; with `--trace 1` its per-layer metrics, each read by
`metrics/<metric>.py` from the run's record. Every number that decides
`correct` is printed beside its limit, last on standard error and last in
the result line. Without a CUDA card, or with fewer than the cell asks
for, the run exits with code 2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# a library the port imports must not load JAX, nor reach for the network
os.environ.update(USE_FLAX="0", USE_TF="0", USE_JAX="0", HF_HUB_OFFLINE="1",
                  TRANSFORMERS_OFFLINE="1", HF_HUB_DISABLE_TELEMETRY="1")
# the cells measure the port's default routes
for _k in ("HIPPOMM_FUSED_BLOCK", "HIPPOMM_FLASH_BTHD", "HIPPOMM_FLASH_ATTN", "HIPPOMM_FUSED_MLP",
           "HIPPOMM_TOPK_ROUTE", "HIPPOMM_ENCODE_ALL_MAX", "HIPPOMM_BPE_PATH"):
    os.environ.pop(_k, None)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

HERE = os.path.join(REPO, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "hippomm_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


def cpu_ticks():
    """(the machine's CPU ticks by kind from /proc/stat, this process's
    user + system ticks, the clock), or None where /proc cannot be read."""
    try:
        with open("/proc/stat") as f:
            machine = [int(x) for x in f.readline().split()[1:]]
        with open("/proc/self/stat") as f:
            own = f.read().rsplit(")", 1)[1].split()
        return machine, int(own[11]) + int(own[12]), time.perf_counter()
    except (OSError, ValueError, IndexError):
        return None


def host_line(a, b) -> str:
    """Where the host's CPUs went between two `cpu_ticks` readings: the
    runs of one cell spread with the host's speed, so each run says it."""
    import torch

    line = (f"host: {len(os.sched_getaffinity(0))} CPUs in affinity, torch threads "
            f"{torch.get_num_threads()} intra-op / {torch.get_num_interop_threads()} inter-op")
    if a is None or b is None:
        return line
    hz, wall = os.sysconf("SC_CLK_TCK"), max(b[2] - a[2], 1e-9)
    line += f"; in the window this process used {(b[1] - a[1]) / hz / wall:.2f} CPUs"
    d = [y - x for x, y in zip(a[0], b[0])]
    total = sum(d)
    if total <= 0:  # a sandbox's /proc/stat may hold zeros
        return line + ", the machine's CPU ticks unreadable"
    busy = total - d[3] - (d[4] if len(d) > 4 else 0)
    steal = d[7] if len(d) > 7 else 0
    return line + f", the machine's CPUs {100.0 * busy / total:.1f} % busy and {100.0 * steal / total:.2f} % stolen"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def read_metric(name: str, record: dict):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        return out.replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def judge(checks: dict, limits: dict):
    """[(name, value, limit, ok)] for every number the program's run read."""
    rows = []
    for name, value in checks.get("program", {}).items():
        limit = limits.get(name)
        ok = limit is not None and value is not None and math.isfinite(value) and value <= limit
        rows.append((name, value, limit, ok))
    return rows


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, control=False, tmpdir=None):
    """Set-up, window and check of one cell: its record."""
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits_path = os.path.join(HERE, "limits", cell["name"] + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    driver = importlib.import_module("portbench.harness." + traffic["driver"])
    marks = {}
    ctx = {"config": cfg, "traffic": traffic, "seed": seed, "seconds": seconds, "trace": trace,
           "device": device, "limits": limits, "control": bool(control), "tmpdir": tmpdir,
           "mark_window_start": lambda: marks.setdefault("start", (process_age_s(), cpu_ticks())),
           "window_closed": lambda: marks.setdefault("close", (forbidden_modules(), cpu_ticks()))}
    record = driver.run(ctx)
    record["setup_s"] = marks.get("start", (math.nan,))[0]
    record["forbidden"] = sorted(set(marks.get("close", ([],))[0]) | set(forbidden_modules()))
    record["host"] = host_line(marks.get("start", (0, None))[1], marks.get("close", (0, None))[1])
    record["limits"] = limits
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(REPO, "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)

    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            v = record["setup_s"] if m["name"] == "setup_s" else record["end_to_end"].get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            v = read_metric(m["name"], record)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    rows = judge(record["checks"], record["limits"])
    correct = bool(rows) and all(ok for *_, ok in rows) and record["failed"] == 0
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
                   "memory_peak_bytes": int(record["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": device_info}
    if args.trace and record.get("trace") is not None:
        tr = record["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = {n: {"value": v if v is not None and math.isfinite(v) else None, "limit": lim}
                      for n, v, lim, _ in rows}
    # the last look for JAX, after every import of the run, the check's too
    forbidden = sorted(set(record["forbidden"]) | set(forbidden_modules()))
    if forbidden:
        print(f"modules of JAX or the JAX package loaded: {forbidden}", file=sys.stderr)
        return 3
    print(record["host"], file=sys.stderr)
    print(f"window {record['window_s']:.3f} s, setup {record['setup_s']:.3f} s, "
          f"sampled {record.get('sampled', '')}, compared {record['checks'].get('counts', {})}",
          file=sys.stderr)
    if record.get("trace") is not None:
        print(f"trace read in {record['trace'].read_s:.3f} s", file=sys.stderr)
    for n, v, lim, ok in rows:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
