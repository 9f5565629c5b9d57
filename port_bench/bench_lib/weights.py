"""Seeded weights of a configuration, made on the device in a few large
draws: the chip smoke's recipe (glorot-uniform kernels; backbone BN the
identity; head and transition BN gain sqrt(2), which makes up for the half
of the variance LeakyReLU removes, and beta N(0, 0.1), so the raw heads are
not all about 0; detection biases 0), with the detection convs' box-size
rows (tw, th of each prior) scaled by ``SIZE_GAIN``: boxes then stay near
their priors, as a trained detector's do, and every seed's frames take the
certified NMS (with the recipe's full-size rows, a seed whose raw outputs
run large gives boxes many times the image, and every call of such a seed
takes the exact retry: a seed that changes the work).  The same tensors go
to the program and to the reference."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference import arch

from . import seeds

SIZE_GAIN = 0.1  # on the detection convs' tw, th rows


def _set(tree: Dict, name: str, block: Dict) -> None:
    *path, last = name.split("/")
    for part in path:
        tree = tree.setdefault(part, {})
    tree[last] = block


def make(cfg: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """(params, stats) as float32 tensors on ``device``."""
    convs = arch.convs(cfg["variant"], cfg["cls_cnt"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, "weights"))
    n_w = sum(c.cout * c.cin * c.k * c.k for c in convs)
    bn = [c for c in convs if c.section in ("head", "trans")]
    uniform = torch.rand(n_w, generator=gen, device=device)
    betas = torch.randn(sum(c.cout for c in bn), generator=gen, device=device)
    params, stats = {}, {}
    off = boff = 0
    for c in convs:
        n = c.cout * c.cin * c.k * c.k
        limit = math.sqrt(6.0 / (c.k * c.k * (c.cin + c.cout)))
        w = (uniform[off:off + n].view(c.cout, c.cin, c.k, c.k) * 2.0 - 1.0) * limit
        off += n
        if c.section == "det":
            chpp = c.cout // arch.N_PRIORS
            for b in range(arch.N_PRIORS):
                w[b * chpp + 2:b * chpp + 4] *= SIZE_GAIN
            _set(params, c.name, {"w": w, "b": torch.zeros(c.cout, device=device)})
            continue
        if c.section == "backbone":
            gamma, beta = torch.ones(c.cout, device=device), torch.zeros(c.cout, device=device)
        else:
            gamma = torch.full((c.cout,), math.sqrt(2.0), device=device)
            beta = betas[boff:boff + c.cout] * 0.1
            boff += c.cout
        _set(params, c.name, {"w": w, "gamma": gamma, "beta": beta})
        _set(stats, c.name, {"mean": torch.zeros(c.cout, device=device),
                             "var": torch.ones(c.cout, device=device)})
    del uniform, betas
    return params, stats
