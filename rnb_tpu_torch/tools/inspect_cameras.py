"""Inspect or compare ``cameras.npz`` files (the port's copy of
``tools/inspect_cameras.py``):

    python -m rnb_tpu_torch.tools.inspect_cameras CAMERAS.npz
        [--compare OTHER.npz]

Prints each view's decomposition of ``world_mat @ scale_mat`` (focal,
principal point, camera centre) and, with ``--compare``, each view's
largest difference of ``world_mat`` and ``scale_mat`` between the files
("OK" below 1e-4, else "DIFF").
"""

from __future__ import annotations

import argparse

import numpy as np

from rnb_tpu_torch.data.cameras import decompose_projection


def describe(path: str):
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("world_mat_")
            and not k.startswith("world_mat_inv"))
    print(f"{path}: {len(data.files)} arrays, {n} views")
    for i in range(n):
        w = data[f"world_mat_{i}"]
        s = data[f"scale_mat_{i}"] if f"scale_mat_{i}" in data.files else np.eye(4)
        K, pose = decompose_projection((w @ s)[:3, :4])
        print(f"  view {i}: focal=({K[0, 0]:.1f},{K[1, 1]:.1f}) "
              f"pp=({K[0, 2]:.1f},{K[1, 2]:.1f}) "
              f"center={np.round(pose[:3, 3], 3).tolist()}")
    return data, n


def compare(a: str, b: str):
    da, na = describe(a)
    db, nb = describe(b)
    for i in range(min(na, nb)):
        for kind in ("world_mat", "scale_mat"):
            ka = f"{kind}_{i}"
            if ka in da.files and ka in db.files:
                diff = np.abs(da[ka] - db[ka]).max()
                marker = "  OK " if diff < 1e-4 else "DIFF "
                print(f"{marker}{ka}: max |Δ| = {diff:.6g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="inspect or compare cameras.npz")
    ap.add_argument("npz", help="cameras.npz to inspect")
    ap.add_argument("--compare", default=None, help="second npz to diff")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.npz, args.compare)
    else:
        describe(args.npz)


if __name__ == "__main__":
    main()
