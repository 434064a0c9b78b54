"""What the port's tracing (``diffdope_tpu_torch.trace``) sees and costs, on
the card, in a cell of the benchmark (``BENCHMARK.json``).

    # the cell's set-up and window with spans on and no profiler (as
    # DD_TRACE=1 runs it): the six readers of the program's spans, an idle
    # share from the stamps, and one row a call, set-up's included
    python tools/port_trace.py window --workload ico5-b64-400.near --seed 7 \
        --seconds 40 --out build/trace_window.json

    # the stamps' device cost (one CapturedRefine captured with them, one
    # without, calls timed by CUDA events in turns) and the host cost of
    # spans on against off
    python tools/port_trace.py cost --workload ico5-b64-400.near --seed 7

Each prints one JSON line; ``window`` also writes its rows to ``--out``.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffdope_tpu_torch import trace  # noqa: E402
from portbench import run  # noqa: E402

READERS = ("table_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
           "update_ms_per_step", "refine_lead_ms", "captures_per_refine")


def card() -> dict:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip()}


def call_rows(spans, t_first):
    """One row a ``CapturedRefine`` call (outermost ``dd.refine``), in order."""
    calls = sorted((s for s in spans if s.name == "dd.refine" and s.parent is None),
                   key=lambda s: s.start_ns)
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent, []).append(s)
    rows = []
    for c in calls:
        kids = {s.name: s for s in by_parent.get(c.id, [])}
        replay = kids.get("dd.refine.replay")
        st = c.stamps
        row = {"t_s": (c.start_ns - t_first) * 1e-9, "wall_ms": (c.end_ns - c.start_ns) * 1e-6,
               "captured": "dd.refine.capture" in kids,
               "lead_ms": None if replay is None or "first_launch_end_ns" not in replay.attrs
               else (replay.attrs["first_launch_end_ns"] - c.start_ns) * 1e-6}
        if st is not None and len(st) and (st > 0).all():
            d = np.diff(st, axis=1) * 1e-6
            row.update(step_ms=float((st[:, trace.END] - st[:, trace.STEP]).mean() * 1e-6),
                       device_ms=float((st[-1, trace.END] - st[0, trace.STEP]) * 1e-6),
                       stamped_ms=float((st[:, trace.END] - st[:, trace.STEP]).sum() * 1e-6),
                       stages_ms=[float(x) for x in d.mean(axis=0)])
        rows.append(row)
    return rows


def window(args) -> dict:
    trace.FORCED = True  # the set-up's calls too, as DD_TRACE=1 from the start
    plan = run.cell_plan(run.load_benchmark(), args.workload)
    out = run.run_cell(plan, args.seed, args.seconds, trace=False)
    view = run.run_view(out, plan, torch.cuda.get_device_name(0))
    metrics = {name: run.metric_reader(name).read(view) for name in READERS}
    spans = trace.take()
    rows = call_rows(spans, min(s.start_ns for s in spans))
    win = rows[-len(out["records"]):]
    stamped_s = sum(r.get("stamped_ms", 0.0) for r in win) * 1e-3
    summary = {"workload": args.workload, "seed": args.seed, **card(),
               "requests": len(out["records"]), "window_s": out["window_s"],
               "refinements_per_s": len(out["records"]) / out["window_s"],
               "setup_s": out["setup_s"], "correct": out["correct"], "metrics": metrics,
               # the share of the window outside every step's stamps: the
               # device's idle share and its work outside the steps
               # (copy-in, results, argmin)
               "unstamped_pct": 100.0 * (1.0 - stamped_s / out["window_s"]),
               "setup_calls": len(rows) - len(win)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary, "calls": rows}))
    return summary


def cost(args) -> dict:
    from diffdope_tpu_torch.optimize import CapturedRefine, pose_params
    from portbench import traffic
    from portbench.entries import make_entry, problem_of, render_pool

    plan = run.cell_plan(run.load_benchmark(), args.workload)
    for k in run.ROUTE_UNSET:
        os.environ.pop(k, None)
    os.environ.update(run.ROUTE_ENV)
    os.environ["DD_TORCH_BUILD_DIR"] = str(ROOT / "build")
    dev = torch.device("cuda")
    config, mix = plan["config"], plan["mix"]
    rng = np.random.default_rng(args.seed)
    problem = problem_of(config)
    q_pool, t_pool = traffic.pool_poses(mix, problem.q_base, problem.t_base, rng)
    frames = render_pool(problem, q_pool, t_pool, dev)
    entry = make_entry(config, problem, frames, dev)
    entry.build()
    req = next(traffic.requests(mix, q_pool, t_pool, np.random.default_rng([args.seed, 1])))
    params0 = pose_params(req.q0, req.t0, problem.batch, dev)
    gt = entry.gt[req.frame]

    stamped = entry.refine
    bare = CapturedRefine(fused_loss_fn=entry.fn, nb_iterations=problem.steps - 1,
                          base_lr=problem.base_lr, lr_decay=problem.lr_decay,
                          optimizer=problem.optimizer)
    stamped(params0, gt=gt)
    real = trace.stamp
    trace.stamp = lambda point: None  # captured without stamps
    try:
        bare(params0, gt=gt)
    finally:
        trace.stamp = real
    same = torch.equal(stamped(params0, gt=gt).mtx_history, bare(params0, gt=gt).mtx_history)

    def device_ms(refine):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        refine(params0, gt=gt)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def host_ms(forced):
        trace.FORCED = forced
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stamped(params0, gt=gt)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            trace.FORCED = False
            trace.take()

    dev_ms = {"stamped": [], "bare": []}
    wall_ms = {"on": [], "off": []}
    for _ in range(args.rounds):
        for name in ("stamped", "bare", "bare", "stamped"):
            dev_ms[name].append(device_ms(stamped if name == "stamped" else bare))
        for on in (False, True, True, False):
            wall_ms["on" if on else "off"].append(host_ms(on))

    def span_us(forced, n=20000):
        trace.FORCED = forced
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("cost") as sp:
                if sp:
                    sp.set(n=n)
        trace.FORCED = False
        trace.take()
        return (time.perf_counter() - t0) / n * 1e6

    replays = problem.steps
    med = {k: statistics.median(v) for k, v in dev_ms.items()}
    return {"workload": args.workload, "seed": args.seed, **card(), "results_equal": same,
            "call_device_ms": dev_ms, "replay_ms": {k: v / replays for k, v in med.items()},
            "stamps_cost_pct": 100.0 * (med["stamped"] / med["bare"] - 1.0),
            "call_wall_ms": wall_ms,
            "tracing_on_cost_ms": statistics.median(wall_ms["on"])
            - statistics.median(wall_ms["off"]),
            "span_us": {"off": span_us(False), "on": span_us(True)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("window", "cost"))
    ap.add_argument("--workload", default="ico5-b64-400.near")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    print(json.dumps(window(args) if args.mode == "window" else cost(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
