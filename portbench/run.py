"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<mix>.json``).  Set-up makes the mix's pool of frames
from the seed with the plain renderer, builds the program's entry
(``portbench/entries.py``) and runs one warm-up refinement; then one client
sends requests, each after the last returned, for ``--seconds``; then the
plain reference checks a sample of what the window returned
(``portbench/check.py``) against the cell's limits
(``portbench/limits/<cell>.json``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` runs the window under the profiler and
reports its per-layer metrics, each read by ``portbench/metrics/<metric>.py``.

The last line of standard output is one JSON object; progress and the
numbers compared, last, go to standard error.  Without a CUDA card, or with
fewer than the cell asks for, it prints no result and exits with 3; if the
process has loaded JAX or the JAX package once the window closes, with 4.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, roofline, traffic  # noqa: E402
from portbench.entries import Record, init_pose, make_entry, problem_of, ref_mesh_of, \
    render_pool  # noqa: E402
from portbench.reference import metrics as ref_metrics  # noqa: E402
from portbench.trace import Tracer, span  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "diffdope_tpu")
#: requests of a run that the reference checks
CHECKED = 2
#: the ADD threshold of the AUC, a share of the object's diameter
AUC_SHARE = 0.1
#: the environment that selects the configured route of the program: the
#: binned compact table and the bf16 d_rows lane
ROUTE_ENV = {"DD_DROWS_BF16": "1"}
ROUTE_UNSET = ("DD_RASTER", "DD_BINNED")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's count), or since
    this module was imported where /proc is not there."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_plan(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The cell's configuration, mix, limits and metrics, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(m):
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (reports(m) if "workloads" in m else m["moves"] in e2e_names)]
    limits_file = root / "portbench" / "limits" / f"{workload}.json"
    return {
        "cell": cell,
        "config": json.loads((root / cfg["file"]).read_text()),
        "mix": traffic.load(cell["traffic"], root / "portbench"),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "limits": json.loads(limits_file.read_text()) if limits_file.exists() else None,
    }


def metric_reader(name: str, root: Path = ROOT):
    """``portbench/metrics/<name>.py``, loaded as a module."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(plan: Dict, seed: int, seconds: float, trace: bool, device="cuda",
             checked: int = CHECKED, window_requests: Optional[int] = None) -> Dict:
    """Set up, run the window, check, and return the run's record:
    'records', 'window_s', 'setup_s', 'rows' (the checks), 'correct' and the rest that
    the result line and the readers take.  ``window_requests`` ends the
    window after that many requests instead of ``seconds`` (tests)."""
    for k in ROUTE_UNSET:
        os.environ.pop(k, None)
    os.environ.update(ROUTE_ENV)
    # the program builds its kernels into the checkout, at one fixed place
    os.environ["DD_TORCH_BUILD_DIR"] = str(ROOT / "build")
    device = torch.device(device)
    on_card = device.type == "cuda"
    config, mix = plan["config"], plan["mix"]
    rng = np.random.default_rng(seed)
    problem = problem_of(config)
    q_pool, t_pool = traffic.pool_poses(mix, problem.q_base, problem.t_base, rng)
    with span("frames"):
        frames = render_pool(problem, q_pool, t_pool, device)
    covered, silhouette = roofline.coverage(frames["seg"])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stream = traffic.requests(mix, q_pool, t_pool, np.random.default_rng([seed, 1]))
    warm = traffic.requests(mix, q_pool, t_pool, np.random.default_rng([seed, 2]))
    entry = make_entry(config, problem, frames, device)
    with span("build"):
        entry.build()
    with span("warmup"):
        for _ in range(int(mix.get("warmup", 1))):
            entry.request(next(warm))
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age()
    log(f"set-up {setup_s:.3f} s; window {seconds} s")

    records: List[Record] = []
    errors: List[str] = []
    tracer = Tracer() if trace else None
    with tracer if tracer is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while (len(records) + len(errors) < window_requests if window_requests
               else time.perf_counter() - t0 < seconds):
            req = next(stream)
            try:
                with span("request"):
                    records.append(entry.request(req))
            except RuntimeError as err:
                errors.append(f"request {req.index}: {err}")
        window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = tracer.summary() if tracer is not None else None

    outputs = [entry.outputs(r) for r in records]
    for r, out in zip(records, outputs):
        r.failed = r.failed or out["overflow"] > 0 or out["leak"] > 0
        r.keep = {}
    counters = entry.counters()
    entry.release()
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    points = problem.pos[: int(problem.tri.max()) + 1].astype(np.float64)
    diam = ref_metrics.diameter(points)
    adds = [ref_metrics.add(points, r.pose, frames["mtx"][r.request.frame]) for r in records]

    check_rng = np.random.default_rng([seed, 3])
    picked = check_rng.choice(len(records), min(checked, len(records)), replace=False) \
        if records else []
    items = []
    for i in sorted(picked):
        r = records[i]
        q0, t0_ = init_pose(problem, r.request.q0, r.request.t0)
        items.append({"frame": r.request.frame, "q0": q0, "t0": t0_, "outputs": outputs[i]})
    mesh = ref_mesh_of(problem, device)
    proj = torch.as_tensor(problem.proj, device=device)
    with span("check"):
        gaps = check.compare(problem, mesh, proj, frames, items, check_rng) if items else {}
    correct, rows = check.verdict(gaps, plan["limits"])
    work = roofline.Work(problem.batch, len(points), int((~mesh.degenerate).sum()), covered,
                         silhouette, 3 if problem.weights.get("rgb") else 0, problem.optimizer)
    return {"records": records, "errors": errors, "window_s": window_s, "setup_s": setup_s,
            "memory_peak": memory_peak, "trace": summary, "adds": adds, "diameter": diam,
            "correct": correct and not errors, "rows": rows, "work": work,
            "counters": counters, "problem": problem, "items": items, "frames": frames,
            "mesh": mesh, "proj": proj}


def end_to_end(out: Dict) -> Dict[str, float]:
    walls = [r.wall_s for r in out["records"]]
    return {
        "refinements_per_s": len(walls) / out["window_s"],
        "refine_ms_p90": float(np.percentile(np.asarray(walls) * 1e3, 90)) if walls else None,
        "add_auc": ref_metrics.auc(out["adds"], AUC_SHARE * out["diameter"]),
        "setup_s": out["setup_s"],
    }


def run_view(out: Dict, plan: Dict, device_kind: str) -> SimpleNamespace:
    """What a per-layer reader reads."""
    steps = sum(r.program.get("steps", 0) for r in out["records"])
    return SimpleNamespace(records=out["records"], trace=out["trace"], work=out["work"],
                           device=device_kind, steps=steps, window_s=out["window_s"],
                           cell=plan["cell"]["name"], counters=out["counters"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    plan = cell_plan(load_benchmark(), args.workload)
    chips = int(plan["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    kind = torch.cuda.get_device_name(0)
    out = run_cell(plan, args.seed, args.seconds, bool(args.trace))

    failed = sum(r.failed for r in out["records"]) + len(out["errors"])
    metrics: Dict[str, Dict] = {}
    if args.trace:
        view = run_view(out, plan, kind)
        for m in plan["per_layer"]:
            value = metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(out)
        for m in plan["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": out["correct"], "attempted": len(out["records"]) + len(out["errors"]),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["rows"]}

    found = forbidden_modules()
    if found:
        log(f"the process holds JAX or the JAX package: {found}")
        return 4
    for err in out["errors"]:
        log(err)
    for name, v, lim in out["rows"]:
        log(f"check {name}: {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
