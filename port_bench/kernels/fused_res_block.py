"""``csrc/fused_res_block.cu``: the 11 residual blocks of the fused early
backbone (1 at C=64, 2 at C=128, 8 at C=256; stride 2, 4, 8), one launch a
block over the call's whole batch: a 1x1 conv C -> C/2 and a 3x3 conv C/2
-> C with folded BN, LeakyReLU and the residual add, bf16 in and out."""

from bench_lib import peaks

PATTERN = r"res_block_kernel"
BLOCKS = ((2, 64, 1), (4, 128, 2), (8, 256, 8))  # (stride, C, launches a pass)


def launch(n, h, w, c):
    """(bytes, operations) of one launch over n images of h x w x c: x read
    and y written once in bf16, both weight tensors in bf16, the BN vectors."""
    weights = (c * (c // 2) + 9 * (c // 2) * c) * 2
    return 2 * n * h * w * c * 2 + weights + 3 * c * 4, n * h * w * 10 * c * c


def work(rec):
    """(bytes, operations, peak) of the traced calls' launches."""
    h, w = rec["image_hw"]
    nbytes = flops = 0
    for stride, c, count in BLOCKS:
        b, f = launch(rec["batch"], h // stride, w // stride, c)
        nbytes, flops = nbytes + count * b, flops + count * f
    calls = rec["run"]["traced_calls"]
    return calls * nbytes, calls * flops, peaks.BF16_FLOPS
