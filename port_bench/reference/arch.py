"""The YOLOv3 topology as data: Darknet-53 (Redmon & Farhadi, arXiv:1804.02767)
and the three detection heads of the Bayesian / aleatoric variants (Kraus &
Dietmayer, arXiv:1905.10296).  Plain Python, shared by the reference, the
seeded weights and the FLOP counter; it imports nothing of the program.

Parameters are nested dicts of tensors under the names the program's
checkpoints use::

    params["backbone"]["conv_00".."conv_51"] = {"w": (cout, cin, k, k), "gamma", "beta"}
    params["head{1,2,3}_conv{0..5}"], params["trans{1,2}"] = {"w", "gamma", "beta"}
    params["det{1,2,3}"] = {"w": (cout, cin, 1, 1), "b": (cout,)}
    stats mirrors every conv block with {"mean", "var"} (BN moving statistics)
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

STRIDES = (32, 16, 8)
N_PRIORS = 3  # per scale
SKIP8_IDX, SKIP16_IDX = 25, 42  # backbone convs whose post-residual output feeds the heads
BRANCH_IDX = 4  # head conv whose output feeds the next scale; dropout on convs 0..4
HEAD_PLANS = {
    1: ((1, 512), (3, 1024), (1, 512), (3, 1024), (1, 512), (3, 1024)),
    2: ((1, 256), (3, 512), (1, 256), (3, 512), (1, 256), (3, 512)),
    3: ((1, 128), (3, 256), (1, 128), (3, 256), (1, 128), (3, 256)),
}
TRANS_PLANS = {1: (1, 256), 2: (1, 128)}  # 1x1 reduce before the 2x upsample
HEAD_CIN = {1: 1024, 2: 256 + 512, 3: 128 + 256}  # upsampled + backbone skip


def backbone_specs() -> List[tuple]:
    """(kernel, cout, stride) of the 52 Darknet-53 convs, in weight-file order."""
    specs = [(3, 32, 1)]
    for cout, blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        specs.append((3, cout, 2))
        specs += [(1, cout // 2, 1), (3, cout, 1)] * blocks
    return specs


def head_channels(variant: str, cls_cnt: int) -> int:
    """Raw channels of one prior: loc 4, obj 1, classes C; doubled (the
    log-variances) for the aleatoric and bayesian heads."""
    base = 4 + 1 + cls_cnt
    return 2 * base if variant in ("aleatoric", "bayesian") else base


class Conv(NamedTuple):
    name: str  # "backbone/conv_07", "head2_conv3", "trans1", "det3"
    k: int
    cin: int
    cout: int
    stride: int
    section: str  # "backbone" | "head" | "trans" | "det"
    scale: int  # output stride


def convs(variant: str, cls_cnt: int) -> List[Conv]:
    """Every convolution of the model, with its section and output stride."""
    out, cin, stride = [], 3, 1
    for i, (k, cout, s) in enumerate(backbone_specs()):
        stride *= s
        out.append(Conv(f"backbone/conv_{i:02d}", k, cin, cout, s, "backbone", stride))
        cin = cout
    det_c = N_PRIORS * head_channels(variant, cls_cnt)
    for head, scale in zip((1, 2, 3), STRIDES):
        cin = HEAD_CIN[head]
        for j, (k, cout) in enumerate(HEAD_PLANS[head]):
            out.append(Conv(f"head{head}_conv{j}", k, cin, cout, 1, "head", scale))
            cin = cout
        out.append(Conv(f"det{head}", 1, cin, det_c, 1, "det", scale))
        if head in TRANS_PLANS:
            k, cout = TRANS_PLANS[head]
            out.append(Conv(f"trans{head}", k, HEAD_PLANS[head][BRANCH_IDX][1], cout, 1,
                            "trans", scale))
    return out


def leaf(tree: Dict, name: str):
    """The parameter block of ``name`` ("backbone/conv_07" or "det1")."""
    for part in name.split("/"):
        tree = tree[part]
    return tree
