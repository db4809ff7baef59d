"""Resolution-curve plotting CLI (the JAX package's ``cli/plot.py``;
reference plt.py):

    python -m deepmetv2_tpu_torch.cli.plot --ckpts ckpts --restore_file best

Reads ``<ckpts>/<restore_file>.resolutions`` (either package's or the
reference's) and writes the five comparison PNGs next to it.  Host only:
no device is used.
"""

from __future__ import annotations

import argparse

from deepmetv2_tpu_torch.plotting import plot_resolutions
from deepmetv2_tpu_torch.utils import artifacts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_file", default="best")
    p.add_argument("--ckpts", default="ckpts")
    args = p.parse_args(argv)

    res = artifacts.load(f"{args.ckpts}/{args.restore_file}.resolutions")
    for w in plot_resolutions(res, f"{args.ckpts}/{args.restore_file}_"):
        print("wrote", w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
