"""Fill a document's dry-run placeholders from the port's artifacts.

Port of ``src/repro/analysis/fill_experiments.py``: the same placeholders
(``<!-- DRYRUN_SUMMARY -->``, ``<!-- DRYRUN_TABLE_16x16 -->``,
``<!-- DRYRUN_TABLE_2x16x16 -->``, ``<!-- ROOFLINE_16x16 -->``,
``<!-- ROOFLINE_2x16x16 -->``) replaced by
:mod:`repro_torch.analysis.report`'s tables, in the file the caller names
(the reference fills its own ``EXPERIMENTS.md``)::

  PYTHONPATH=src python -m repro_torch.analysis.fill_experiments PATH
"""

from __future__ import annotations

import argparse

from repro_torch.analysis.report import ART, dryrun_table, roofline_table, summary

__all__ = ["fill", "main"]


def fill(path: str, art: str = ART) -> tuple:
    """Replace the placeholders in ``path`` in place; returns the two
    meshes' summaries."""
    with open(path) as f:
        text = f.read()
    s16 = summary("16x16", art)
    s512 = summary("2x16x16", art)
    summ = (
        f"* single pod (16×16, 256 cards): **{s16['traced']}/{s16['cells']} cells "
        f"trace**, {s16['fits']}/{s16['traced']} fit 80 GB HBM; bounds: "
        f"{s16['bounds']['memory']} memory / {s16['bounds']['collective']} "
        f"collective / {s16['bounds']['compute']} compute.\n"
        f"* multi-pod (2×16×16, 512 cards): **{s512['traced']}/{s512['cells']} "
        f"cells trace**, {s512['fits']}/{s512['traced']} fit 80 GB HBM."
    )
    repl = {
        "<!-- DRYRUN_SUMMARY -->": summ,
        "<!-- DRYRUN_TABLE_16x16 -->": dryrun_table("16x16", art),
        "<!-- DRYRUN_TABLE_2x16x16 -->": dryrun_table("2x16x16", art),
        "<!-- ROOFLINE_16x16 -->": roofline_table("16x16", art),
        "<!-- ROOFLINE_2x16x16 -->": roofline_table("2x16x16", art),
    }
    for k, v in repl.items():
        text = text.replace(k, v)
    with open(path, "w") as f:
        f.write(text)
    return s16, s512


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="the document whose placeholders to fill")
    args = ap.parse_args(argv)
    s16, s512 = fill(args.path)
    print(f"{args.path} filled:", s16, s512)


if __name__ == "__main__":
    main()
