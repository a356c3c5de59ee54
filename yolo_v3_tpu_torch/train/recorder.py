"""Training metrics recorder (reference Recorder, train.py:171-205).

The port's own copy of ``yolo_v3_tpu/train/recorder.py``.

Tracks per-net-batch loss components and recall.  The reference has an EWMA
hook that is currently pass-through (train.py:196-201); we keep both: raw
current stats (the reference's active policy) and an optional EWMA window.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

LOSS_KEYS = ("loss_x", "loss_y", "loss_w", "loss_h", "loss_conf", "loss_cls", "loss")
EVAL_KEYS = ("recall",)


def ewma_online(new_value: float, previous: float, window: int) -> float:
    """Exponential weighted moving average (reference utils.py:288-291)."""
    alpha = 2.0 / (window + 1.0)
    return alpha * new_value + (1 - alpha) * previous


class Recorder:
    def __init__(self, ewma_window: Optional[int] = None,
                 jsonl_path: Optional[str] = None):
        """``jsonl_path``: append one JSON line of raw (pre-EWMA) stats per
        net-batch — the training-curve artifact (the reference only prints
        to the tqdm bar, train.py:86-88; a file survives the run)."""
        self.ewma_window = ewma_window
        self.keys = LOSS_KEYS + EVAL_KEYS
        self.current_stats: "OrderedDict[str, float]" = OrderedDict(
            (k, 0.0) for k in self.keys
        )
        self.ewma_stats: "OrderedDict[str, float]" = OrderedDict(
            (k, 0.0) for k in self.keys
        )
        self.history: list = []
        self.net_batches_seen = 0
        self.jsonl_path = jsonl_path

    def on_batch_end(self, batch_stats: Dict[str, float],
                     batch_datasize: int = 0) -> None:
        stats = {k: float(batch_stats[k]) for k in self.keys if k in batch_stats}
        self.net_batches_seen += 1
        if self.jsonl_path:
            import json

            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(
                    {"net_batch": self.net_batches_seen,
                     "datasize": batch_datasize, **stats}) + "\n")
        if self.ewma_window:
            for k, v in stats.items():
                prev = self.ewma_stats[k]
                self.ewma_stats[k] = v if prev == 0.0 else ewma_online(
                    v, prev, self.ewma_window
                )
        else:  # reference's active policy: raw per-net-batch values
            self.ewma_stats.update(stats)
        self.current_stats.update(
            {k: self.ewma_stats[k] for k in stats}
        )

    def on_epoch_end(self) -> None:
        pass

    def state_dict(self) -> Dict:
        return {"ewma_stats": dict(self.ewma_stats),
                "net_batches_seen": self.net_batches_seen}

    def load_state_dict(self, sd: Dict) -> None:
        self.net_batches_seen = int(sd.get("net_batches_seen", 0))
        self.ewma_stats.update(sd["ewma_stats"])
        self.current_stats.update(
            {k: self.ewma_stats[k] for k in self.keys if k in self.ewma_stats}
        )

    def stats_row(self) -> str:
        return " ".join(f"{k}={v:.4g}" for k, v in self.current_stats.items())
