"""The harness finds a cell's configuration, traffic mix, limits, driver and
metrics by name alone: a dummy of each in a temporary directory is found
and used without an edit to any file of the harness."""

import json
import os

from rnbbench import harness


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_a_new_cell_is_found_by_its_files(tmp_path):
    bench = tmp_path / "bench"
    spec = {"workloads": [{"name": "toy.cell", "config": "toy", "traffic": "toy.mix",
                           "chips": 1, "why": "a dummy"}],
            "end_to_end": [{"name": "toy_rate", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["toy.cell"]},
                           {"name": "setup_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock"}],
            "per_layer": [{"name": "toy.count", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "toy",
                           "moves": "toy_rate"},
                          {"name": "other.count", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "toy",
                           "moves": "toy_rate", "workloads": ["elsewhere"]}]}
    _write(str(tmp_path / "BENCHMARK.json"), json.dumps(spec))
    _write(str(bench / "configs" / "toy.json"), json.dumps({"conf": {"a": {"b": 1}},
                                                            "sets": ["a.c=2"]}))
    _write(str(bench / "traffic" / "toy.mix.json"), json.dumps({"mode": "toy",
                                                                "sets": ["a.b=3"]}))
    _write(str(bench / "cells" / "toy.cell.json"), json.dumps({"limits": {"gap": 1.0}}))
    _write(str(bench / "drivers" / "toy.py"), "def setup(ctx):\n    return 'toy state'\n")
    _write(str(bench / "metrics" / "toy.count.py"),
           "def read(rec):\n    return rec.units * 2\n")

    cell = harness.load_cell("toy.cell", root=str(tmp_path), bench_dir=str(bench))
    assert cell.conf == {"a": {"b": 3, "c": 2}}
    assert cell.limits == {"limits": {"gap": 1.0}}
    assert [m["name"] for m in cell.end_to_end] == ["toy_rate", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["toy.count"]
    assert harness.driver("toy", bench_dir=str(bench)).setup(None) == "toy state"

    rec = harness.LayerRecord(cell="toy.cell", conf={}, peak_flops=1.0,
                              peak_bytes=1.0, units=21, rays_per_unit=1, trace=None,
                              spans={})
    assert harness.read_metrics(cell, rec, bench_dir=str(bench)) == {
        "toy.count": {"value": 42.0, "unit": "1"}}


def test_every_name_in_the_benchmark_has_its_file():
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.driver(cell.traffic["mode"]).setup
        for m in cell.per_layer:
            assert harness.metric_reader(m["name"]).read


TOY_METRIC = '''from rnbbench.harness import Boundary

BOUNDARY = Boundary("rnbbench_toyprog", "work", "ToyBackward")


def read(rec):
    s = rec.device_s(BOUNDARY)
    return 1e3 * s / rec.units if s > 0 else None
'''


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_a_new_op_metric_brings_its_own_boundary(tmp_path, monkeypatch):
    """A metric file that declares a boundary in the program gets its range
    and its device time, forward and backward, with no edit of the harness."""
    bench = tmp_path / "bench"
    spec = {"workloads": [{"name": "toy.cell", "config": "toy", "traffic": "toy.mix",
                           "chips": 1, "why": "a dummy"}],
            "end_to_end": [{"name": "toy_rate", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock"}],
            "per_layer": [{"name": "toy_ms", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "toy",
                           "moves": "toy_rate", "workloads": ["toy.cell"]}]}
    _write(str(tmp_path / "BENCHMARK.json"), json.dumps(spec))
    _write(str(bench / "configs" / "toy.json"), json.dumps({"conf": {}}))
    _write(str(bench / "traffic" / "toy.mix.json"), json.dumps({"mode": "toy"}))
    _write(str(bench / "cells" / "toy.cell.json"), json.dumps({"limits": {}}))
    _write(str(bench / "metrics" / "toy_ms.py"), TOY_METRIC)
    _write(str(tmp_path / "rnbbench_toyprog.py"), "def work(x):\n    return x + 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import rnbbench_toyprog

    cell = harness.load_cell("toy.cell", root=str(tmp_path), bench_dir=str(bench))
    want = harness.Boundary("rnbbench_toyprog", "work", "ToyBackward")
    assert harness.boundaries(cell, bench_dir=str(bench)) == [want]
    work = rnbbench_toyprog.work
    with harness.cell_spans(cell, bench_dir=str(bench)) as spans:
        assert rnbbench_toyprog.work is not work and rnbbench_toyprog.work(1) == 2
    assert rnbbench_toyprog.work is work and len(spans.seconds[want.range]) == 1

    # a kernel launched inside the op's range (main thread), one inside its
    # backward node (autograd's thread), one outside both
    events = [_x("user_annotation", "rnbbench::window", 0, 1000, 1),
              _x("user_annotation", want.range, 100, 200, 1),
              _x("cuda_runtime", "cudaLaunchKernel", 150, 5, 1, 7),
              _x("kernel", "toy_fwd", 160, 250, 9, 7),
              _x("cpu_op", "autograd::engine::evaluate_function: ToyBackward", 500, 100, 2),
              _x("cuda_runtime", "cudaLaunchKernel", 550, 5, 2, 8),
              _x("kernel", "toy_bwd", 560, 100, 9, 8),
              _x("cuda_runtime", "cudaLaunchKernel", 800, 5, 1, 9),
              _x("kernel", "other", 810, 50, 9, 9)]
    path = str(tmp_path / "trace.json")
    _write(path, json.dumps({"traceEvents": events}))
    tr = harness.reduce_trace(path, 1e-3, harness.boundaries(cell, bench_dir=str(bench)))
    assert abs(tr.op_device_s[want] - 350e-6) < 1e-12
    assert abs(tr.busy_s - 400e-6) < 1e-12
    rec = harness.LayerRecord(cell="toy.cell", conf={}, peak_flops=1.0, peak_bytes=1.0,
                              units=2, rays_per_unit=1, trace=tr, spans=spans.seconds)
    got = harness.read_metrics(cell, rec, bench_dir=str(bench))
    assert abs(got["toy_ms"]["value"] - 0.175) < 1e-9 and got["toy_ms"]["unit"] == "ms"
