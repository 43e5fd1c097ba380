"""``benchmark/flops.py``: one hand count of each kind, and the whole step's
count against ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference's forward and backward at a tiny size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, weights
from benchmark.reference import step as ref_step
from benchmark.tests import tiny

torch.set_num_threads(2)


def test_linear_counts():
    assert flops.linear(197, 3072, 9216) == (2 * 197 * 3072 * 9216, 0)
    assert flops.linear(10, 4, 6, trained=True) == (480, 960)
    assert flops.linear(10, 4, 6, trained=True, input_grad=False) == (480, 480)


def test_conv_count():
    # 3x3, 128 -> 256 channels, 112 x 112 outputs, 2 images
    assert flops.conv2d(2, 112, 112, 128, 256, 3) == 2 * 2 * 112 * 112 * 256 * 128 * 9


def test_attention_counts_and_bound():
    f, b = flops.attention(16, 197, 24, 128)
    assert f == 4 * 16 * 24 * 197 ** 2 * 128 and b == 2 * f
    fb, bb = flops.attention_bytes(16, 197, 24, 128)
    x = 16 * 197 * 24 * 128 * 2
    assert fb == 4 * x + 2 * 16 * 197 * 64 * 4 and bb == 7 * x + 2 * 16 * 197 * 64 * 4
    # at L=197 the bytes bound the call, at L=964 the operations do
    assert flops.least_seconds(*map(sum, zip((f, b), (fb, bb))))[1] == "bytes"
    f2, b2 = flops.attention(16, 964, 24, 128, rope=True)
    t, by = flops.least_seconds(f2 + b2, sum(flops.attention_bytes(16, 964, 24, 128)))
    assert by == "operations" and t == pytest.approx((f2 + b2) / 989e12)


@pytest.mark.parametrize("mode", ["image", "video"])
def test_step_count_matches_the_flop_counter(mode):
    model = tiny.cell(mode).model
    rows = 3
    P = weights.reference_params(model, 7, "cpu")
    for k in P:
        P[k].requires_grad_(ref_step.M.trainable(model, k))
    lat = ref_step.M.latent_size(model)
    g = torch.Generator().manual_seed(0)
    draws = {"t": torch.rand(rows, generator=g),
             "x0": torch.randn(rows, (lat // 2) ** 2, 4 * model["vae"]["z_channels"],
                               generator=g),
             "vae_noise": torch.randn(rows, lat, lat, model["vae"]["z_channels"], generator=g)}
    s = model["img_size"]
    if mode == "image":
        batch = {"image": torch.rand(rows, s, s, 3, generator=g)}
    else:
        batch = {"cond": torch.rand(rows, 3, s, s, 3, generator=g),
                 "target": torch.rand(rows, s, s, 3, generator=g),
                 "valid": torch.ones(rows, dtype=torch.bool)}
    with FlopCounterMode(display=False) as counter:
        ref_step.micro_loss_backward(P, model, batch, draws, 1.0, rows)
    assert counter.get_total_flops() == sum(flops.step_parts(model, rows).values())
