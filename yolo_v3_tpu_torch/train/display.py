"""Console training display: fixed-width stats rows + tqdm progress.

The port's own copy of ``yolo_v3_tpu/train/display.py``.

Equivalent of the reference's stats/progress helpers (reference
train.py:137-167): a header, per-net-batch fixed-width rows, and an
epoch-scoped tqdm bar.
"""

from __future__ import annotations

import sys
from typing import Optional

STAT_COLS = ("loss_x", "loss_y", "loss_w", "loss_h", "loss_conf", "loss_cls",
             "loss", "recall")


def stats_header() -> str:
    return "{:>9s} {:>5s} ".format("net_batch", "epoch") + " ".join(
        f"{k:>9s}" for k in STAT_COLS
    )


def stats_row(net_batch: int, epoch: int, recorder) -> str:
    vals = [recorder.current_stats.get(k, 0.0) for k in STAT_COLS]
    return "{:>9d} {:>5d} ".format(net_batch, epoch) + " ".join(
        f"{v:<9.5g}" for v in vals
    )


class ProgressDisplay:
    """tqdm-backed progress with stats in the description; degrades to plain
    prints when tqdm is missing.  Pass ``.log`` as the train loop's
    ``log_fn`` replacement or drive it manually."""

    def __init__(self, data, use_tqdm: bool = True):
        self.data = data
        self.pbar = None
        self.use_tqdm = use_tqdm
        self._printed_header = False

    def update(self, recorder) -> None:
        if not self._printed_header:
            print(stats_header(), file=sys.stderr)
            self._printed_header = True
        row = stats_row(self.data.get_net_batch(), self.data.get_epoch(), recorder)
        if self.use_tqdm:
            try:
                from tqdm import tqdm

                if self.pbar is None or self.data.is_start_of_epoch():
                    if self.pbar is not None:
                        self.pbar.close()
                    self.pbar = tqdm(
                        file=sys.stderr, leave=False,
                        initial=self.data.get_epoch_batch(),
                        total=self.data.get_epoch_num_batches(),
                    )
                self.pbar.set_description_str(row)
                self.pbar.update()
                return
            except ImportError:
                self.use_tqdm = False
        print(row, file=sys.stderr)

    def close(self) -> None:
        if self.pbar is not None:
            self.pbar.close()
