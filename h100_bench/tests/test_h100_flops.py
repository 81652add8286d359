"""The FLOP and byte counts against a hand count for one site."""

from h100_bench import flops, peaks
from h100_bench.reference import model as ref

# one read, one allele, one site of the illumina model, by hand:
READ_CONV = 2 * (3 * 6 * 16 * 148 + 3 * 16 * 16 * 146 + 3 * 16 * 32 * 144
                 + 6 * 3 * 32 * 32 * 71 + 3 * 32 * 64 * 36
                 + 3 * 64 * 64 * 36 + 32 * 64 * 36 + 6 * 3 * 64 * 64 * 36)
COMPRESSOR = 2 * (64 * 64 * 36                      # 1x1 conv on 36
                  + 3 * 64 * 128 * 18 + 3 * 128 * 128 * 18
                  + 64 * 128 * 18                   # stride-2 block
                  + 4 * 3 * 128 * 128 * 18)         # two residual blocks
HEAD = 2 * (128 * 128 * 18
            + 3 * 128 * 256 * 9 + 3 * 256 * 256 * 9 + 128 * 256 * 9
            + 4 * 3 * 256 * 256 * 9 + 256 * 1)


def test_read_convolver_per_read():
    assert READ_CONV == flops.FLOPS_PER_READ == 10_152_192
    net = ref.config("illumina")
    assert flops.network_flops(net["read_conv0"], 150) == (READ_CONV, 36)


def test_one_site_by_hand():
    net = ref.config("illumina")
    assert flops.network_flops(net["compressor0"], 36)[0] == COMPRESSOR
    assert flops.network_flops(net["xattn0"], 18)[0] == HEAD
    # the compressor runs on the allele and on the site's sum
    assert flops.forward_flops(net, [1], 1, 1) == \
        READ_CONV + 2 * COMPRESSOR + HEAD
    assert flops.train_flops(net, [1], 1, 1) == \
        3 * (READ_CONV + 2 * COMPRESSOR + HEAD)


def test_kernel_work_and_roofline():
    f, b = flops.read_conv_work(10, 2)
    assert f == 10 * READ_CONV
    assert b == 10 * (150 * 6 + 4 + 4) + 2 * 36 * 64 * 4
    # compute bound at bf16: FLOPs over 989 TFLOP/s
    assert peaks.roofline_seconds(f, b, "bf16") == f / 989e12
    assert peaks.flops_peak("highest") == 165e12
