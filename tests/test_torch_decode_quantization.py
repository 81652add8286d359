"""Why a precision sweep's largest quality delta says little above Q57.

The device decode (``nn/genotype.decode_pairs_device``, the same arithmetic
as hello_tpu's) forms a pair's log-probability as ``l0 + (l1 - l0)``.  For
a confident call ``l0 = log(1 - sigmoid(x))`` is near ``-x``, so its fp32
ulp (2^-20 for 8 <= x < 16) swamps ``l1 = log(sigmoid(x))``, about
``-e^-x``: ``1 - p`` comes out as a whole number of those ulps, and the
quality as Q80 (zero ulps, the cap), Q60.2 (one), Q57.2 (two) and so on.
A logit moved by bf16 arithmetic by 0.1 can cross one rounding boundary and
move the quality by 19.8 where the host decode moves it by 1.25.  Both
packages decode alike, bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hello_tpu.nn import genotype as jax_genotype
from hello_tpu_torch.nn.genotype import (_decode_site_fast,
                                         decode_pairs_device, phred_quality)

torch.set_num_threads(1)

# the single-allele logit of the port's worst pacbio site at highest, the
# port's bf16 and hello_tpu's bf16, as ``python
# tests/test_torch_precision_pacbio.py --variants 5200`` prints them (CPU)
LOGITS = [14.751943588256836, 14.639287948608398, 14.692240715026855,
          13.5, 9.25, 17.5]


def _port_q(x):
    d = decode_pairs_device(torch.tensor([[x]], dtype=torch.float32), None,
                            torch.tensor([0]), torch.tensor([1.0]), 1)
    return phred_quality(float(d["best_p"][0]))


def _jax_q(x):
    d = jax_genotype.decode_pairs_device(
        jnp.asarray([[x]], jnp.float32), None, jnp.asarray([0]),
        jnp.asarray([1.0]), 1)
    return phred_quality(float(np.asarray(d["best_p"])[0]))


def _host_q(x):
    return phred_quality(_decode_site_fast(np.array([[x]], np.float32), None,
                                           ["A"])[1])


@pytest.mark.parametrize("x", LOGITS)
def test_device_decode_quantizes_one_minus_p(x):
    q = _port_q(x)
    assert q == _jax_q(x)
    ulp = 2.0 ** (math.floor(math.log2(x)) - 23)     # fp32 ulp of l0 ~ -x
    one_minus_p = 10 ** (-q / 10)
    if q < 79.9:
        assert abs(one_minus_p / ulp - round(one_minus_p / ulp)) < 1e-6
    # the host decode follows the logit, -10 log10(e^-x), to the fp32 ulp of
    # the sigmoid (2^-24) below the cap
    host = _host_q(x)
    assert host > 79.9 or abs(host - 10 * x / math.log(10)) < 1.0


def test_a_small_logit_move_flips_the_capped_quality():
    highest, bf16 = LOGITS[0], LOGITS[1]
    assert abs(_port_q(highest) - _port_q(bf16)) > 19
    assert abs(_host_q(highest) - _host_q(bf16)) < 1.3
