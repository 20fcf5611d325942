"""MSE and PSNR of two images, or of the same-named images of two
directories, with optional |a−b| images (the port's copy of
``tools/compare_images.py``, reading through the port's own PNG codec):

    python -m rnb_tpu_torch.tools.compare_images A B [--diff_dir DIR]

One line per pair: ``mse=<mse> psnr=<psnr> dB`` (prefixed by the name for
directories; ``SHAPE MISMATCH`` where the sizes differ).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rnb_tpu_torch.utils import io


def mse_psnr(a: np.ndarray, b: np.ndarray):
    """(mse, psnr in dB) of two images of one shape, values in [0, 1]."""
    mse = float(((a - b) ** 2).mean())
    return mse, 10 * np.log10(1.0 / max(mse, 1e-12))


def compare_pair(a_path: str, b_path: str, diff_out: str | None = None):
    """``mse_psnr`` of two image files, or None when their shapes differ;
    writes |a − b| to ``diff_out`` when given."""
    a = io.load_image(a_path)
    b = io.load_image(b_path)
    if a.shape != b.shape:
        return None
    if diff_out:
        io.save_image(diff_out, np.abs(a - b))
    return mse_psnr(a, b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--diff_dir", default=None)
    args = ap.parse_args(argv)

    if os.path.isdir(args.a):
        names = sorted(set(os.listdir(args.a)) & set(os.listdir(args.b)))
        for n in (n for n in names if n.lower().endswith(".png")):
            diff = os.path.join(args.diff_dir, n) if args.diff_dir else None
            r = compare_pair(os.path.join(args.a, n), os.path.join(args.b, n), diff)
            print(f"{n}: SHAPE MISMATCH" if r is None
                  else f"{n}: mse={r[0]:.6f} psnr={r[1]:.2f} dB")
    else:
        diff = os.path.join(args.diff_dir, "diff.png") if args.diff_dir else None
        r = compare_pair(args.a, args.b, diff)
        if r is None:
            raise SystemExit("shape mismatch")
        print(f"mse={r[0]:.6f} psnr={r[1]:.2f} dB")


if __name__ == "__main__":
    main()
