"""What every cell shares: finding its files by name, the run's directory,
the program's runner set up on the seeded capture and weights, the spans
around the program's layers, the reduction of a profiler trace, and the
card.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``cells/<cell>.json`` (the limits of the correctness check), drives
``drivers/<mode>.py`` (the traffic's ``mode``) and reads each per-layer
metric with ``metrics/<metric>.py``, whose ``BOUNDARY``, where it declares
one, names the function of the program that the harness wraps in a range
for it. Nothing here names a cell, an op or a metric.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every mfu and roofline is taken against the bf16 dense peak (NVIDIA's
# data sheet, SXM part, 700 W) and the HBM3 rate, whatever the code runs in
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 SXM5 80GB": 989e12,
}
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 SXM5 80GB": 3.35e12,
}
# the CPU runs of the tests count operations only; these stand in so that
# the arithmetic runs, and no CPU number is reported under a device name
CPU_STAND_IN = ("cpu", 989e12, 3.35e12)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def conf(self) -> dict:
        """The conf as it is run: the configuration's, with the
        configuration's and then the traffic's ``sets`` applied."""
        conf = json.loads(json.dumps(self.config["conf"]))
        for s in list(self.config.get("sets", [])) + list(self.traffic.get("sets", [])):
            path, _, raw = s.partition("=")
            node = conf
            keys = path.split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = json.loads(raw)
        return conf


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric is read in the cells its ``workloads`` list; without the key,
    an end-to-end metric in every cell, and a per-layer metric in every cell
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files under
    ``bench_dir``; KeyError names what is missing."""
    spec = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(bench_dir, "configs", w["config"] + ".json"),
                traffic=load_json(bench_dir, "traffic", w["traffic"] + ".json"),
                limits=load_json(bench_dir, "cells", name + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(mode: str, bench_dir: str = HERE):
    """The module ``drivers/<mode>.py``."""
    return _load_file(os.path.join(bench_dir, "drivers", mode + ".py"),
                      f"rnbbench_driver_{mode}")


def metric_reader(name: str, bench_dir: str = HERE):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    return _load_file(os.path.join(bench_dir, "metrics", name + ".py"),
                      "rnbbench_metric_" + name.replace(".", "_"))


def _load_file(path: str, modname: str):
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def card(device) -> dict:
    """Name, power limit (nvidia-smi, where it answers) and peaks."""
    if device.type != "cuda":
        name, flops, hbm = CPU_STAND_IN
        return {"name": name, "power_limit": "n/a", "peak_flops": flops,
                "peak_bytes": hbm}
    name = torch.cuda.get_device_name(device)
    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    if name not in PEAK_BF16_FLOPS:
        raise SystemExit(f"no bf16 peak known for the card {name!r}")
    return {"name": name, "power_limit": limit,
            "peak_flops": PEAK_BF16_FLOPS[name], "peak_bytes": PEAK_HBM_BYTES[name]}


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the program on the seeded inputs
# ---------------------------------------------------------------------------

def hocon(conf: dict, indent: int = 0) -> str:
    """A nested dict as the conf syntax the program reads."""
    pad = "    " * indent
    lines = []
    for k, v in conf.items():
        if isinstance(v, dict):
            lines += [f"{pad}{k} {{", hocon(v, indent + 1), f"{pad}}}"]
        elif isinstance(v, list):
            lines.append(f"{pad}{k} = [{', '.join(_scalar(x) for x in v)}]")
        else:
            lines.append(f"{pad}{k} = {_scalar(v)}")
    return "\n".join(lines)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


def run_dir() -> str:
    """A fresh directory of this run under the run's TMPDIR."""
    return tempfile.mkdtemp(prefix="rnbbench_", dir=tempfile.gettempdir())


@dataclasses.dataclass
class Program:
    """The program's runner on the seeded capture, and what made it."""
    runner: object
    scene: object
    conf: dict


def start_program(cell: Cell, seed: int, device, work_dir: str, mode: str):
    """Write the seeded capture and the conf under ``work_dir``, build the
    program's ``Runner`` on them and copy the seeded weights into it."""
    from rnbbench import scene as scenelib
    from rnbbench import weights as wlib
    from rnb_tpu_torch.train.runner import Runner

    conf = cell.conf
    t0 = time.perf_counter()
    scene = scenelib.make_scene(seed, cell.config["data"], device)
    case_dir = os.path.join(work_dir, "data", "bench")
    scenelib.write_case(scene, case_dir)
    t1 = time.perf_counter()
    conf["general"]["base_exp_dir"] = os.path.join(work_dir, "exp")
    conf["dataset"]["data_dir"] = case_dir + "/"
    path = os.path.join(work_dir, "run.conf")
    with open(path, "w") as f:
        f.write(hocon(conf) + "\n")
    runner = Runner(path, mode=mode, case="bench", seed=seed, device=str(device))
    wlib.copy_into(runner.state.params, wlib.make(conf["model"], seed, device))
    print(f"set-up: capture made and written {t1 - t0:.3f} s, runner built "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr, flush=True)
    return Program(runner=runner, scene=scene, conf=conf)


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# boundaries in the program that metrics read (the harness's own ranges)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Boundary:
    """A function of the program that a per-layer metric reads, declared by
    the metric's file as ``BOUNDARY``: the harness wraps ``module.attr`` in a
    ``record_function`` range and a host clock. An op's device time is that
    of the kernels launched inside the range and, where ``backward`` names
    the op's autograd node, inside that node's range."""
    module: str
    attr: str
    backward: str = ""

    @property
    def range(self) -> str:
        return f"rnbbench::{self.module}.{self.attr}"


class Spans:
    """Wrap the ``boundaries`` (looked up by name at call time) in their
    ranges and a host clock; restore them on exit. ``seconds[range]`` lists
    the host seconds of each call; ``last[range]`` keeps the last call's
    (args, result) for the boundaries in ``keep``."""

    def __init__(self, boundaries, keep=()):
        self.targets = {b.range: b for b in boundaries}
        self.keep = {b.range for b in keep}
        self.seconds = {r: [] for r in self.targets}
        self.last = {}
        self._saved = []

    def __enter__(self):
        for rng, b in self.targets.items():
            mod = importlib.import_module(b.module)
            orig = getattr(mod, b.attr)
            self._saved.append((mod, b.attr, orig))
            setattr(mod, b.attr, self._wrap(orig, rng))
        return self

    def _wrap(self, fn, rng):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(rng):
                out = fn(*args, **kwargs)
            self.seconds[rng].append(time.perf_counter() - t0)
            if rng in self.keep:
                self.last[rng] = (args, out)
            return out
        return wrapped

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


def boundaries(cell: Cell, bench_dir: str = HERE) -> list:
    """The boundaries the cell's per-layer metric files declare."""
    out = []
    for m in cell.per_layer:
        b = getattr(metric_reader(m["name"], bench_dir), "BOUNDARY", None)
        if b is not None and b not in out:
            out.append(b)
    return out


def cell_spans(cell: Cell, extra=(), keep=(), bench_dir: str = HERE) -> Spans:
    """Spans around the cell's metric boundaries and a driver's ``extra``."""
    return Spans(boundaries(cell, bench_dir) + list(extra), keep=keep)


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@contextlib.contextmanager
def traced(device, out_path: str):
    """Profile the block (CPU and, on the card, CUDA activity) inside a
    ``rnbbench::window`` range ending on a synchronise; write the Chrome
    trace to ``out_path``. Yields a dict that gets ``window_s``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    info = {}
    prof = torch.profiler.profile(activities=acts)
    synchronize(device)
    prof.start()
    t0 = time.perf_counter()
    with torch.profiler.record_function("rnbbench::window"):
        yield info
        synchronize(device)
    info["window_s"] = time.perf_counter() - t0
    prof.stop()
    prof.export_chrome_trace(out_path)


@dataclasses.dataclass
class Trace:
    """A reduced trace: device seconds in all (``busy_s``), by kernel name
    (``by_kernel``), inside each boundary asked for (``op_device_s``, by
    ``Boundary``), and the idle gaps by what the host was in
    (``idle_by_host``)."""
    window_s: float
    busy_s: float
    by_kernel: dict
    op_device_s: dict
    idle_by_host: dict


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(ranges, ts) -> bool:
    """Whether ``ts`` lies in one of the sorted, non-overlapping ranges."""
    i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= ts <= ranges[i][1]


def _innermost(events, ts, depth: int = 2000):
    """The name of the latest-starting event of ``events`` (sorted (start,
    end, name)) that is open at ``ts``, or None."""
    j = bisect.bisect_right(events, (ts, float("inf"), "")) - 1
    for k in range(j, max(j - depth, -1), -1):
        if events[k][1] >= ts:
            return events[k][2]
    return None


def reduce_trace(path: str, window_s: float, bounds=()) -> Trace:
    """Read a Chrome trace written by ``traced``; device seconds inside each
    of the ``Boundary``s ``bounds``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next(e for e in events if e.get("name") == "rnbbench::window"
                  and e.get("cat") == "user_annotation")
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    main_tid = window["tid"]
    device, launches, host = [], {}, {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat in HOST_CATS:
            host.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
    by_kernel, busy = {}, []
    for e in device:
        s, d = float(e["ts"]), float(e.get("dur", 0))
        busy.append((max(s, w0), min(s + d, w1)))
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + d * 1e-6
    busy = _merge([b for b in busy if b[1] > b[0]])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    # the ranges of each op boundary, by thread, sorted by start
    ranges = {}
    for b in bounds:
        for tid, evs in host.items():
            rs = sorted((s, e) for s, e, n in evs
                        if n == b.range or (b.backward and b.backward in n))
            if rs:
                ranges.setdefault(b, {})[tid] = rs
    op_s = {b: 0.0 for b in bounds}
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for op, by_tid in ranges.items():
            if _inside(by_tid.get(launch[0], []), launch[1]):
                op_s[op] += float(e.get("dur", 0)) * 1e-6

    # idle gaps inside the window, named by the innermost host event of the
    # main thread open at the gap's start
    idle, t = {}, w0
    main = sorted(ev for ev in host.get(main_tid, []) if ev[2] != "rnbbench::window")
    for s, e in busy + [[w1, w1]]:
        if s > t:
            name = _innermost(main, t + 0.5) or "host outside any op"
            idle[name] = idle.get(name, 0.0) + (s - t) * 1e-6
        t = max(t, e)
    return Trace(window_s=window_s, busy_s=busy_s, by_kernel=by_kernel,
                 op_device_s=op_s, idle_by_host=idle)


def breakdown(tr: Trace) -> dict:
    top = sorted(tr.by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerRecord:
    """What a metric reader reads: the cell, the conf as run, the card's
    peaks, the units of work in the traced window (``steps``, ``frames``,
    ``meshes``, ``rays`` a unit), the reduced trace and the host seconds of
    each call by range (``Spans.seconds``)."""
    cell: str
    conf: dict
    peak_flops: float
    peak_bytes: float
    units: int
    rays_per_unit: int
    trace: Trace
    spans: dict

    def device_s(self, b: Boundary) -> float:
        """Device seconds of the kernels launched inside ``b``."""
        return self.trace.op_device_s.get(b, 0.0)

    def host_s(self, b: Boundary) -> list:
        """Host seconds of each call of ``b``."""
        return self.spans.get(b.range, [])


def read_metrics(cell: Cell, rec: LayerRecord, bench_dir: str = HERE,
                 log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Each of the cell's per-layer metrics its reader finds something to
    read for; a listed metric that reads nothing is named on ``log``."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], bench_dir).read(rec)
        if value is None:
            log(f"rnbbench: {m['name']} found nothing to read in {cell.name}")
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
