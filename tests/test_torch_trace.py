"""The program's recorder (``rnb_tpu_torch.utils.trace``) on the CPU.

  * off, ``span`` is the one shared null context: no clock read, no
    ``record_function``, nothing recorded;
  * inside ``recording()``: parents (across threads), self time, request
    ids, counters, the launch delta and the bounded buffer;
  * under ``torch.profiler.profile``: the ``rnb::`` ranges nested in the
    exported Chrome trace as recorded, in a recording of their own;
  * a 3-step ``train_rnb`` records each step phase once a step and logs the
    losses of an unrecorded run bit for bit; ``render_novel_image`` and
    ``validate_mesh`` record theirs;
  * no span name breaks the benchmark's readers (``rnbbench/harness.py``);
  * the four metric readers that read the spans, through
    ``rnbbench.harness.read_metrics`` on CPU traced runs.
"""

import dataclasses
import json
import os
import re
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from rnb_tpu_torch.ops import _build
from rnb_tpu_torch.tools.make_synthetic_case import write_case
from rnb_tpu_torch.train.runner import Runner
from rnb_tpu_torch.utils import trace
from rnbbench import harness

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

CONF = """
general {{
    base_exp_dir = {exp_dir}
    recording = []
}}
dataset {{
    data_dir = {data_dir}
    normal_dir = normal
    albedo_dir = albedo
    mask_dir = mask
    render_cameras_name = cameras.npz
    object_cameras_name = cameras.npz
}}
train {{
    learning_rate = 5e-4,
    learning_rate_alpha = 0.05,
    end_iter = {end_iter},
    warm_up_iter = 2,
    batch_size = 32,
    validate_resolution_level = 1,
    warm_up_end = 5,
    anneal_end = 0,
    save_freq = 100,
    val_freq = 100,
    val_mesh_freq = 100,
    report_freq = 4,
    igr_weight = 0.1,
    mask_weight = 0.1,
}}
model {{
    nerf {{ D = 2, d_in = 4, d_in_view = 3, W = 32, multires = 4,
           multires_view = 2, output_ch = 4, skips = [0], use_viewdirs = True }}
    sdf_network {{ d_out = 33, d_in = 3, d_hidden = 32, n_layers = 4,
                   skip_in = [2], multires = 4, bias = 0.5, scale = 1.0,
                   geometric_init = True, weight_norm = True }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{ d_feature = 32, mode = no_view_dir, d_in = 6,
                         d_out = 3, d_hidden = 16, n_layers = 2,
                         weight_norm = True, multires_view = 2,
                         squeeze_out = True }}
    neus_renderer {{ n_samples = 8, n_importance = 8, n_outside = 4,
                     up_sample_steps = 2, perturb = 1.0 }}
}}
"""

STEP_PHASES = ("runner.step", "step.draws", "step.batch", "step.zero_grad",
               "step.forward", "step.backward", "step.optimizer",
               "renderer.upsample", "renderer.outside", "renderer.core",
               "sdf_core.pack", "sdf_core.fwd", "sdf_core.bwd", "albedo.pack",
               "albedo.fwd", "albedo.bwd", "nerf.pack", "nerf.fwd", "nerf.bwd")
FRAME_SPANS = ("render.frame", "render.rays", "render.fetch",
               "render.fetch.wait", "fields.fold")
# the spans a frame's chunk records below the renderer (no backward)
FRAME_OPS = ("render.chunk", "renderer.upsample", "renderer.outside",
             "renderer.core", "sdf_core.pack", "sdf_core.fwd", "albedo.pack",
             "albedo.fwd", "nerf.pack", "nerf.fwd")
MESH_SPANS = ("runner.validate_mesh", "renderer.grid_query",
              "renderer.grid_fetch", "renderer.grid_fetch.wait",
              "mesh.marching_cubes", "io.write_ply")
# what the benchmark's trace reduction matches by substring or prefix
BACKWARD_NODES = ("_SDFCoreBackward", "_NeRFBackward", "_AlbedoBackward")


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace") / "sphere"
    write_case(str(d), n_views=3, H=8, W=8, radius=0.4, device="cpu")
    return str(d)


def _runner(tmp, case_dir, end_iter=3) -> Runner:
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "t.conf")
    with open(path, "w") as f:
        f.write(CONF.format(exp_dir=os.path.join(tmp, "exp"), data_dir=case_dir,
                            end_iter=end_iter))
    return Runner(path, device="cpu")


def _losses(runner) -> dict:
    with open(os.path.join(runner.base_exp_dir, "logs", "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["Loss/loss"] for r in recs if "Loss/loss" in r}


@pytest.fixture(scope="module")
def trained(tmp_path_factory, case_dir):
    """A runner after one step, for the inference spans."""
    r = _runner(str(tmp_path_factory.mktemp("trained")), case_dir, end_iter=1)
    r.train_rnb()
    return r


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_is_the_shared_null_context_and_records_nothing(monkeypatch):
    """Off, a span costs the one check: the clock and record_function are
    never reached, and nothing is kept."""
    def refuse(*a, **k):
        raise AssertionError("reached while tracing is off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(trace.torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_open", refuse)
    assert not trace.active()
    assert trace.span("a") is trace.NULL and trace.span("b", 3) is trace.NULL
    with trace.span("a") as got:
        assert got is None
    trace.count("bytes_to_host", 5)
    trace.wait("a.wait", "cpu")
    assert trace.spanned("f")(lambda x: x + 1)(1) == 2
    s = trace.summary()
    assert s["spans"] == {} and s["counters"] == {} and s["dropped"] == 0


def test_recording_keeps_parents_self_time_requests_and_counters(monkeypatch):
    monkeypatch.setitem(_build.launches, "sdf_core_fwd",
                        _build.launches["sdf_core_fwd"])

    def other_thread():
        with trace.span("c"):
            time.sleep(0.01)
            trace.count("bytes_to_card", 5)

    with trace.recording():
        with trace.span("a", request=7):
            time.sleep(0.01)
            with trace.span("b"):
                time.sleep(0.02)
                trace.count("bytes_to_host", 10)
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            _build.launches["sdf_core_fwd"] += 2
        with trace.span("d"):
            pass
    s = trace.summary()
    sp = s["spans"]
    assert {k: v["calls"] for k, v in sp.items()} == {"a": 1, "b": 1, "c": 1, "d": 1}
    # a's self time is its total less its children's, the other thread's too
    assert sp["a"]["self_s"] == pytest.approx(
        sp["a"]["total_s"] - sp["b"]["total_s"] - sp["c"]["total_s"], abs=1e-8)
    assert sp["b"]["total_s"] >= 0.02 and sp["a"]["self_s"] >= 0.01
    assert sp["b"]["self_s"] == sp["b"]["total_s"]
    assert sp["b"]["counters"] == {"bytes_to_host": 10}
    assert sp["c"]["counters"] == {"bytes_to_card": 5}
    assert s["counters"] == {"bytes_to_host": 10, "bytes_to_card": 5}
    assert s["launches"] == {"sdf_core_fwd": 2}
    # the children inherit the request, on either thread; d has none
    assert set(trace.summary(request=7)["spans"]) == {"a", "b", "c"}
    assert trace.summary(request=7)["counters"] == s["counters"]
    assert trace.summary(request=8)["spans"] == {}
    # the recording stays readable after the block
    assert not trace.active() and trace.summary()["spans"] == sp


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching as often as the interpreter
    allows: every span and every count of every thread is kept."""
    n_threads, n = 2 * (os.cpu_count() or 4), 300

    def work():
        for _ in range(n):
            with trace.span("t"):
                trace.count("bytes_to_host", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            with trace.span("root", request=1):
                threads = [threading.Thread(target=work) for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    s = trace.summary()
    assert s["spans"]["t"]["calls"] == n_threads * n
    assert s["counters"] == {"bytes_to_host": n_threads * n}
    assert s["spans"]["t"]["counters"] == {"bytes_to_host": n_threads * n}
    assert trace.summary(request=1)["spans"]["t"]["calls"] == n_threads * n


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace._REC, "max_spans", 2)
    with trace.recording():
        for _ in range(5):
            with trace.span("x"):
                pass
    s = trace.summary()
    assert s["spans"]["x"]["calls"] == 2 and s["dropped"] == 3


def test_profiler_trace_holds_the_spans_nested(tmp_path):
    """Under a profiler the spans are user annotations of the Chrome trace,
    nested as recorded, in a recording that starts afresh."""
    with trace.recording():
        with trace.span("before"):
            pass
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        assert trace.active()
        with trace.span("outer", request=1):
            with trace.span("inner"):
                torch.ones(8).sum()
            trace.wait("outer.wait", "cpu")
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith(trace.PREFIX)]
    got = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events}
    assert set(got) == {"rnb::outer", "rnb::inner", "rnb::outer.wait"}
    for child in ("rnb::inner", "rnb::outer.wait"):
        assert got["rnb::outer"][0] <= got[child][0] <= got[child][1] <= got["rnb::outer"][1]
    s = trace.summary()
    assert set(s["spans"]) == {"outer", "inner", "outer.wait"}
    assert set(trace.summary(request=1)["spans"]) == set(s["spans"])
    assert not trace.active()


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def test_train_rnb_records_each_phase_once_a_step_and_keeps_the_losses(
        tmp_path, case_dir):
    plain = _runner(str(tmp_path / "plain"), case_dir)
    plain.train_rnb()
    rec = _runner(str(tmp_path / "rec"), case_dir)
    with trace.recording():
        rec.train_rnb()
    assert _losses(rec) == _losses(plain) and sorted(_losses(rec)) == [1, 2, 3]
    s = trace.summary()
    for name in STEP_PHASES:
        assert s["spans"][name]["calls"] == 3, name
        for it in range(3):
            assert trace.summary(request=("step", it))["spans"][name]["calls"] == 1, (
                name, it)
    for name in ("runner.train_rnb", "runner.snapshot", "runner.fetch",
                 "runner.fetch.wait"):
        assert s["spans"][name]["calls"] == 1, name
    assert s["spans"]["runner.log"]["calls"] >= 1
    assert s["spans"]["runner.fetch"]["counters"] == {"bytes_to_host": 3 * 8 * 4}
    assert s["spans"]["runner.snapshot"]["counters"]["bytes_to_host"] > 0


def test_render_and_mesh_record_their_spans(trained):
    with trace.recording():
        img = trained.render_novel_image(0, 1, 0.5, 1)
        trained.validate_mesh(resolution=16)
    s = trace.summary()
    for name in FRAME_SPANS + MESH_SPANS:
        assert s["spans"][name]["calls"] >= 1, name
    assert s["spans"]["render.frame"]["calls"] == 1
    assert s["spans"]["render.chunk"]["calls"] == -(-(img.size // 3) // 32)
    # a request id names its kind, so frame n and mesh n do not mix
    assert set(trace.summary(request=("frame", trained._frames))["spans"]) == set(
        FRAME_SPANS + FRAME_OPS)
    assert set(trace.summary(request=("mesh", trained._meshes))["spans"]) == set(
        MESH_SPANS)
    assert trace.summary(request=trained._frames)["spans"] == {}
    assert s["spans"]["render.fetch"]["counters"] == {"bytes_to_host": img.size * 4}
    assert s["spans"]["render.rays"]["counters"] == {"bytes_to_card": 2 * img.size * 4}
    assert s["spans"]["renderer.grid_fetch"]["counters"] == {"bytes_to_host": 16 ** 3 * 2}


def _span_names_in_source() -> set:
    pat = re.compile(r'trace\.(?:span|spanned|wait)\(\s*"([^"]+)"')
    names = set()
    for path in (ROOT / "rnb_tpu_torch").rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    return names


def test_span_names_keep_the_benchmarks_readers(trained):
    """No span name holds an autograd node's name that a metric matches by
    substring, none starts as the harness's ranges do, and every function a
    metric's BOUNDARY wraps keeps its module and name."""
    with trace.recording():
        trained.render_novel_image(0, 1, 0.25, 1)
        trained.validate_mesh(resolution=16)
    names = _span_names_in_source()
    assert set(FRAME_SPANS + MESH_SPANS + STEP_PHASES) <= names
    assert set(trace.summary()["spans"]) <= names
    for name in names:
        full = trace.PREFIX + name
        assert not any(node in full for node in BACKWARD_NODES), name
        assert not full.startswith("rnbbench::"), name
    for mfile in (ROOT / "rnbbench" / "metrics").glob("*.py"):
        b = getattr(harness.metric_reader(mfile.stem), "BOUNDARY", None)
        if b is not None:
            fn = getattr(__import__(b.module, fromlist=[b.attr]), b.attr)
            assert fn.__name__ == b.attr and fn.__module__ == b.module, b


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _record(cell_name, metric, conf, units, tr) -> tuple:
    cell = harness.load_cell(cell_name)
    cell.per_layer = [m for m in cell.per_layer if m["name"] == metric]
    assert len(cell.per_layer) == 1
    rec = harness.LayerRecord(cell=cell_name, conf=conf, peak_flops=1.0,
                              peak_bytes=1.0, units=units, rays_per_unit=1,
                              trace=tr, spans={})
    return cell, rec


def _with_idle_gaps(path: str, out: str) -> None:
    """The CPU trace with the card busy all through the window but for a
    short gap where each of the main thread's ``rnb::`` ranges starts."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    window = next(e for e in events if e.get("name") == "rnbbench::window")
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    gaps = harness._merge(
        [(float(e["ts"]), float(e["ts"]) + min(float(e["dur"]), 2.0))
         for e in events if e.get("ph") == "X" and e.get("tid") == window["tid"]
         and e.get("name", "").startswith(trace.PREFIX)])
    t, busy = w0, []
    for s, e in gaps + [[w1, w1]]:
        if s > t:
            busy.append((t, s))
        t = max(t, e)
    events += [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 0,
                "ts": s, "dur": e - s, "args": {}} for s, e in busy]
    with open(out, "w") as f:
        json.dump(doc, f)


def test_host_idle_reader(tmp_path, case_dir):
    r = _runner(str(tmp_path), case_dir, end_iter=1)
    r.train_rnb()
    r.tcfg = dataclasses.replace(r.tcfg, end_iter=3)
    path = str(tmp_path / "trace.json")
    with harness.traced(torch.device("cpu"), path) as info:
        r.train_rnb()
    _with_idle_gaps(path, str(tmp_path / "gaps.json"))
    tr = harness.reduce_trace(str(tmp_path / "gaps.json"), info["window_s"])
    named = sum(v for k, v in tr.idle_by_host.items() if k.startswith(trace.PREFIX))
    assert named > 0
    cell, rec = _record("wmask_rnb.train.b4096", "host_idle_ms.train", {}, 2, tr)
    got = harness.read_metrics(cell, rec, log=lambda s: None)
    assert got == {"host_idle_ms.train": {"value": 1e3 * named / 2, "unit": "ms"}}


@pytest.mark.parametrize("cell_name,metric", [
    ("wmask_rnb.render.b4096", "frame_host_ms.render"),
    ("wmask_rnb.mesh.r512", "grid_fetch_s"),
    ("wmask_rnb.mesh.r512", "ply_write_s"),
])
def test_host_clock_readers(tmp_path, trained, cell_name, metric):
    path = str(tmp_path / "trace.json")
    with harness.traced(torch.device("cpu"), path) as info:
        for _ in range(2):
            if metric == "frame_host_ms.render":
                trained.render_novel_image(0, 1, 0.5, 1)
            else:
                trained.validate_mesh(resolution=16)
    tr = harness.reduce_trace(path, info["window_s"])
    sp = trace.summary()["spans"]
    if metric == "frame_host_ms.render":
        want = 1e3 * (sp["render.rays"]["self_s"] + sp["render.fetch"]["self_s"]) / 2
    elif metric == "grid_fetch_s":
        want = sp["renderer.grid_fetch"]["self_s"] / 2
    else:
        want = sp["io.write_ply"]["total_s"] / 2
    assert want > 0
    cell, rec = _record(cell_name, metric, {}, 2, tr)
    got = harness.read_metrics(cell, rec, log=lambda s: None)
    assert got[metric]["value"] == pytest.approx(want, rel=1e-12)
    # the fetch's self time leaves its wait out
    if metric == "grid_fetch_s":
        g = sp["renderer.grid_fetch"]
        assert g["self_s"] == pytest.approx(
            g["total_s"] - sp["renderer.grid_fetch.wait"]["total_s"], abs=1e-8)


def test_readers_read_nothing_without_spans(tmp_path):
    """A program that records no spans (one older than this recorder) reads
    as no value, not as an error."""
    tr = harness.Trace(window_s=1.0, busy_s=0.5, by_kernel={}, op_device_s={},
                       idle_by_host={"host outside any op": 0.5})
    for cell_name, metric in [("wmask_rnb.train.b4096", "host_idle_ms.train"),
                              ("wmask_rnb.render.b4096", "frame_host_ms.render"),
                              ("wmask_rnb.mesh.r512", "grid_fetch_s"),
                              ("wmask_rnb.mesh.r512", "ply_write_s")]:
        cell, rec = _record(cell_name, metric, {}, 1, tr)
        assert harness.read_metrics(cell, rec, log=lambda s: None) == {}, metric
