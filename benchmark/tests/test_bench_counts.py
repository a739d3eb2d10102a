"""The frozen counts against hand counts."""

import pytest

from benchmark import counts

TINY_MLP = {"arch": "mlp", "in_features": 1, "hidden_features": 4,
            "out_features": 1, "num_sine": 2, "num_snake": 1, "num_tanh": 1}
TINY_KAN = {"arch": "kan", "layers_hidden": [1, 2, 3, 1], "grid_size": 2,
            "spline_order": 1}


def test_mlp_hand_counts():
    # 1*4 + 4 hidden layers of 4*4 + 4*1
    assert counts.macs_row(TINY_MLP) == 4 + 4 * 16 + 4
    # weights and biases, and one snake layer's a
    assert counts.param_floats(TINY_MLP) == (
        (4 + 4) + 4 * (16 + 4) + (4 + 1) + 4)
    # five layers end in an activation of 4 units, 20 operations each
    assert counts.act_ops_row(TINY_MLP) == 20 * 5 * 4


def test_kan_hand_counts():
    j = 2 + 1 + 1
    assert counts.macs_row(TINY_KAN) == (1 * 2 + 2 * 3 + 3 * 1) * j
    # base_w, spline_w (3 coefficients), scaler; knots 2 + 2 + 1 a feature
    assert counts.param_floats(TINY_KAN) == sum(
        o * i * 5 + i * 5 for i, o in [(1, 2), (2, 3), (3, 1)])
    # silu 5, one level of the recursion: one term of 5, 2, and 2
    assert counts.kan_feature_ops(1) == 5 + 5 + 2 + 2
    assert counts.act_ops_row(TINY_KAN) == 14 * (1 + 2 + 3)


def test_runner_sizes():
    mlp = {**TINY_MLP, "hidden_features": 256, "num_snake": 2, "num_tanh": 0}
    kan = {**TINY_KAN, "layers_hidden": [1, 256, 256, 1], "grid_size": 5,
           "spline_order": 3}
    assert counts.macs_row(mlp) == 262_656
    assert counts.macs_row(kan) == 594_432
    assert counts.train_step_flop(mlp, 10) == 6 * 262_656 * 10
    assert counts.forward_flop(kan, 10) == 2 * 594_432 * 10


def test_population_hand_counts():
    headline = {**TINY_MLP, "hidden_features": 128, "num_snake": 2,
                "num_tanh": 0}
    # (1*128 + 128) + 4 (128*128 + 128) + (128 + 1), and two snake a's
    assert counts.param_floats(headline) == 66_689
    assert counts.macs_row(headline) == 65_792
    # 669 windows of 512 rows: a step's model FLOP
    assert counts.train_step_flop(headline, 669 * 512) == 6 * 65_792 * 342_528
    # each window's parameters count once; one window reads as the model
    sweep = counts.sweep_work(TINY_MLP, 100, windows=3)
    assert sweep.bytes == 4 * 100 * 2 + 3 * 4 * counts.param_floats(TINY_MLP)
    assert counts.sweep_work(TINY_MLP, 100, 1) == counts.sweep_work(TINY_MLP,
                                                                    100)
    # 2 windows x 3 steps, 4 of which improved: 7 floats a parameter, and 1
    ep = counts.epilogue_work(TINY_MLP, 6, 4)
    assert ep.bytes == 4 * counts.param_floats(TINY_MLP) * (7 * 6 + 4)
    assert ep.tensor_flop == ep.f32_flop == 0


def test_least_time_takes_the_larger_bound():
    w = counts.Work(989e12, 0.0, 0.0)
    assert w.least_s() == pytest.approx(1.0)
    w = counts.Work(989e12, 2 * 67e12, 3.35e12)
    assert w.least_s() == pytest.approx(2.0)
    fwd = counts.forward_work(TINY_MLP, 100)
    assert fwd.tensor_flop == 2 * 72 * 100
    assert fwd.bytes == 4 * 100 * 2 + 4 * counts.param_floats(TINY_MLP)
    sweep = counts.sweep_work(TINY_MLP, 100)
    assert sweep.tensor_flop == 2 * fwd.tensor_flop
    assert sweep.f32_flop == 2 * fwd.f32_flop
