"""A pool of seeded frames, the chip smoke's recipe: coarse noise blown up
16x (so frames compress like camera frames) with six bright boxes.  Made on
the device in bulk, handed over as pageable host memory, where a camera's or
a data set's frames arrive from and as the port's own loader hands them to
``predict``: the copy to the card is part of what a call costs."""

from __future__ import annotations

import numpy as np
import torch

from . import seeds


def pool(seed: int, n: int, hw, device) -> np.ndarray:
    """(n, H, W, 3) uint8 frames in host memory."""
    h, w = int(hw[0]), int(hw[1])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, "frames"))
    coarse = torch.randint(0, 160, (n, h // 16, w // 16, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    img = coarse.repeat_interleave(16, dim=1).repeat_interleave(16, dim=2)
    ys = torch.randint(0, h - h // 4, (n, 6), generator=gen, device=device).tolist()
    xs = torch.randint(0, w - w // 8, (n, 6), generator=gen, device=device).tolist()
    cols = torch.randint(160, 256, (n, 6, 3), generator=gen, device=device, dtype=torch.uint8)
    for i in range(n):
        for j in range(6):
            img[i, ys[i][j]:ys[i][j] + h // 4, xs[i][j]:xs[i][j] + w // 10] = cols[i, j]
    return img.cpu().numpy()
