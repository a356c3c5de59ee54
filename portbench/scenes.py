"""Seeded uint8 RGB scenes, made on the device in a few large calls.

A scene is a coarse random colour field, upsampled by 16 and cut to size,
plus grain of +-20: smooth regions and edges, as photographs have, in every
size of the mix.  Scene ``i`` has size ``sizes[i % len(sizes)]``, so every
seed gets the same sizes in the same order.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def make_pool(n: int, sizes_wh: Sequence[Sequence[int]], seed: int, device) -> List[np.ndarray]:
    """``n`` HWC uint8 scenes on the host, sizes cycling through ``sizes_wh``
    ((width, height) pairs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = len(sizes_wh)
    groups = []
    for j, (w, h) in enumerate(sizes_wh):
        m = len(range(j, n, k))
        coarse = torch.randint(0, 255, (m, h // 16 + 1, w // 16 + 1, 3), generator=gen,
                               device=device, dtype=torch.int16)
        img = coarse.repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :h, :w]
        img = img + torch.randint(-20, 20, (m, h, w, 3), generator=gen, device=device,
                                  dtype=torch.int16)
        groups.append(img.clamp(0, 255).to(torch.uint8).cpu().numpy())
    return [groups[i % k][i // k] for i in range(n)]
