"""Merge the port's gate records into one (the port's counterpart of
``tools/consolidate_parity_r5.py``):

    python -m rnb_tpu_torch.tools.consolidate_parity [--out exp/parity_port.json]

Reads, under the current directory, the records the gate drivers write:
``exp/parity_matrix.json`` (``run_parity_matrix``: the wmask, womask and
two no-albedo gates), ``exp/parity_worldspace.json``
(``run_parity_worldspace``) and ``exp/e2e.json`` (``run_e2e``). Each gate
is one row: its threshold, Chamfer-L1, ``pass`` / ``fail`` / ``missing``,
the card line of its record, and the JAX package's number for the same
gate, read from the record the repository keeps of it (``PARITY_*.json``,
``docs/RUN_REPORT_r3.md``). A gate whose record is absent but whose
experiment directory holds meshes is re-gated with
``rnb_tpu_torch.tools.acceptance``, as the JAX tool does; a gate with
neither is a ``missing`` row, which never counts as a pass. Writes the
merged record to ``--out``, prints it as one JSON line, and exits 0 only
when every gate passed.
"""

from __future__ import annotations

import argparse
import json
import os
import re

from rnb_tpu_torch.tools.run_parity_matrix import ROOT, gate
from rnb_tpu_torch.tools.run_parity_worldspace import CENTER

# gate: (record, its keys to the gate's acceptance record, threshold,
# experiment directory, warm-up steps, centre, the JAX number's file and
# keys); a record's own threshold wins over the one here
GATES = {
    "wmask": ("exp/parity_matrix.json", ("variants", "wmask_rnb"), 0.004,
              "exp/torus_deg/wmask_rnb", 20000, None,
              ("PARITY_r5_kernel.json", ("variants", "wmask_rnb", "chamfer_l1"))),
    "womask": ("exp/parity_matrix.json", ("variants", "womask_rnb"), 0.008,
               "exp/torus_deg/womask_rnb", 20000, None,
               ("PARITY_r5_womask_fusednerf.json",
                ("variants", "womask_rnb", "chamfer_l1"))),
    "wmask_noalbedo": ("exp/parity_matrix.json",
                       ("variants", "wmask_rnb_noalbedo"), 0.004,
                       "exp/torus_deg/wmask_rnb_noalbedo", 20000, None,
                       ("PARITY_r4.json",
                        ("variants", "wmask_rnb_noalbedo", "chamfer_l1"))),
    "womask_noalbedo": ("exp/parity_matrix.json",
                        ("variants", "womask_rnb_noalbedo"), 0.008,
                        "exp/torus_deg/womask_rnb_noalbedo", 20000, None,
                        ("PARITY_r5_womask_noalb.json",
                         ("variants", "womask_rnb_noalbedo", "chamfer_l1"))),
    "worldspace": ("exp/parity_worldspace.json", ("wmask_rnb",), 0.004,
                   "exp/torus_ns/wmask_rnb", 20000, CENTER,
                   ("PARITY_r5_worldspace.json", ("wmask_rnb", "chamfer_l1"))),
    "e2e": ("exp/e2e.json", (), 0.005, "exp/torus_e2e/wmask_rnb", 20000, None,
            ("docs/RUN_REPORT_r3.md", ())),
}


def load(path: str):
    """The JSON record at ``path``, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def dig(rec, keys):
    for k in keys:
        if not isinstance(rec, dict) or k not in rec:
            return None
        rec = rec[k]
    return rec


def jax_number(path: str, keys) -> float | None:
    """The JAX package's Chamfer-L1 for a gate, from the repository's
    record of it (a JSON file, or the run report's JSON excerpt)."""
    full = os.path.join(ROOT, path)
    if not os.path.exists(full):
        return None
    if path.endswith(".json"):
        return dig(load(full), keys)
    m = re.search(r'"chamfer_l1": ([0-9.eE-]+)', open(full).read())
    return float(m.group(1)) if m else None


def row(name: str) -> dict:
    path, keys, threshold, exp_dir, warm, center, (jfile, jkeys) = GATES[name]
    rec = load(path)
    acc = dig(rec, keys) if rec is not None else None
    out = {"gate": name, "jax_chamfer_l1": jax_number(jfile, jkeys),
           "jax_source": jfile, "card": (rec or {}).get("card")}
    if acc is None and os.path.isdir(os.path.join(exp_dir, "meshes")):
        acc = gate(exp_dir, warm, threshold, center)
        path = f"re-gated {exp_dir}"
    if acc is None:
        where = f"no {name} row in {path}" if rec is not None else f"no {path}"
        return dict(out, source=None, threshold=threshold, chamfer_l1=None,
                    status="missing",
                    failures=[f"{where} and no meshes under {exp_dir}"])
    # the e2e record holds the gate's acceptance record beside its
    # kill-and-resume checks; the whole record decides
    threshold = (acc.get("acceptance") or acc).get("threshold", threshold)
    return dict(out, source=path, threshold=threshold,
                chamfer_l1=acc.get("chamfer_l1"),
                failures=acc.get("failures", []),
                status="pass" if acc.get("accepted") else "fail")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("exp", "parity_port.json"))
    args = ap.parse_args(argv)
    rows = [row(name) for name in GATES]
    out = {"gates": rows,
           "all_accepted": all(r["status"] == "pass" for r in rows),
           "missing": [r["gate"] for r in rows if r["status"] == "missing"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["all_accepted"] else 1)
