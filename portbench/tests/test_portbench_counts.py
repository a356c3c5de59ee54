"""The operation counter against darknet's published figures, and the byte
count of one 1x1 and one 3x3 against a hand computation."""

import pytest

from portbench import counts as C

BLOCKS = (1, 2, 8, 8, 4)


@pytest.mark.parametrize("size,gflop", [(320, 38.973), (416, 65.864), (608, 140.692)])
def test_forward_flops_match_darknet(size, gflop):
    assert C.forward_flops(BLOCKS, 80, size) / 1e9 == pytest.approx(gflop, abs=5e-4)
    assert len(C.conv_layers(BLOCKS, 80, size)) == 75


def test_conv_bytes_by_hand():
    layers = {l["name"]: l for l in C.conv_layers(BLOCKS, 80, 416)}
    one = layers["head0/conv0"]            # 1x1, 13 x 13, 1024 -> 512
    assert C._conv_bytes(one, 32, 2, 2, 2, 8) == (32 * 169 * 1024 * 2 + 1024 * 512 * 2
                                                 + 32 * 169 * 512 * 2 + 512 * 8)
    three = layers["stage2/res0/conv2"]    # 3x3, 52 x 52, 128 -> 256, + residual
    assert C._conv_bytes(three, 32, 1, 1, 1, 8, residual=True) == (
        32 * 2704 * 128 + 9 * 128 * 256 + 32 * 2704 * 256 + 256 * 8 + 32 * 2704 * 256)


def test_bf16_block_bound_matches_the_kernel_table():
    # 0.342 ms at batch 8 (PERF.md's kernel table): 208^2 bound by bytes
    assert C.group_bound_s("res_block_bf16", BLOCKS, 80, 416, 8) * 1e3 == pytest.approx(
        0.3418, abs=1e-4)
