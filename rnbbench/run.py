"""Run one cell of the benchmark once, on the machine this starts on.

    python3 -m rnbbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are found by name (``rnbbench.harness``), its driver by the
traffic's ``mode``. The run makes the capture and the weights from
``--seed``, sets up the program (``setup_s``: process start to the first
timed step), then either measures ``--seconds`` of its traffic with tracing
off (``--trace 0``: the cell's end-to-end metrics) or profiles a short
window of it (``--trace 1``: the cell's per-layer metrics, ``busy_s``,
``window_s`` and the breakdown). Then the program is freed and the plain
reference checks what the timed path produced.

Standard error gets the card's name and power limit first and the numbers
of the check beside their limits last; the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), and ``check`` last.

Exits non-zero without printing a result when CUDA is absent or has fewer
cards than the cell asks for, when the program is not beside the
benchmark, or when a module of JAX or of the JAX package is loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rnb_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    def __init__(self, cell, seed, seconds, device, work_dir):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.work_dir = device, work_dir


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             log=lambda s: print(s, file=sys.stderr, flush=True),
             numbers_out=None) -> dict:
    """Set up, measure, free and check one run of ``cell`` on ``device``;
    -> the result object (without the device checks of ``main``).
    ``numbers_out``, a dict, gets every number the check computed, compared
    or not."""
    import torch

    from rnbbench import compare, harness

    crd = harness.card(device)
    log(f"card: {crd['name']}, power limit {crd['power_limit']}")
    drv = harness.driver(cell.traffic["mode"])
    work_dir = harness.run_dir()
    ctx = Ctx(cell, seed, seconds, device, work_dir)
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        state = drv.setup(ctx)
        setup_s = time.time() - T_PROCESS
        result = {"attempted": 0, "failed": 0}
        metrics = {}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": crd["name"], "count": 1}
        if trace:
            units, rays, spans, info = drv.traced_window(
                ctx, state, os.path.join(work_dir, "trace.json"))
            tr = harness.reduce_trace(os.path.join(work_dir, "trace.json"),
                                      info["window_s"], harness.boundaries(cell))
            rec = harness.LayerRecord(
                cell=cell.name, conf=state.prog.conf,
                peak_flops=crd["peak_flops"], peak_bytes=crd["peak_bytes"],
                units=units, rays_per_unit=rays, trace=tr, spans=spans.seconds)
            metrics = harness.read_metrics(cell, rec, log=log)
            result["attempted"] = units
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            brk = harness.breakdown(tr)
        else:
            out = drv.window(ctx, state)
            result.update(attempted=out["attempted"], failed=out["failed"])
            metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in out["metrics"]}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        dev["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                    if device.type == "cuda" else 0)
        log(f"setup_s {setup_s:.3f}; peak memory {dev['memory_peak_bytes']} bytes "
            f"({crd['name']}, {crd['power_limit']})")
        t_check = time.time()
        numbers = drv.check(ctx, state)
        log(f"check took {time.time() - t_check:.3f} s")
        correct, rows = compare.verdict(numbers, cell.limits["limits"])
        if numbers_out is not None:
            numbers_out.update(numbers)
        for n in sorted(set(numbers) - set(cell.limits["limits"])):
            log(f"not compared {n} {numbers[n]}")
    finally:
        harness.remove(work_dir)
    result.update(correct=bool(correct), metrics=metrics, device=dev)
    if trace:
        result["breakdown"] = brk
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        log(f"check {n} {v} limit {lim}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(root, "rnb_tpu_torch")):
        print("rnbbench: the program (rnb_tpu_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    import torch

    from rnbbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rnbbench: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"rnbbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
