"""The yardstick's operation counts and aggregation floors against values
worked out by hand at a tiny size."""
import pytest

from benchmark import counts

CONFIG = {"dataset": {"num_nodes": 10, "num_features": 3, "num_classes": 2},
          "model": {"hidden_dim": 4, "hidden_layers": 2, "maxk": 2}}
EDGES = 20


def test_epoch_flops_by_hand():
    # N 10, F 3, H 4, C 2, L 2, E 20, k 2
    lin_in = 2 * 10 * 3 * 4                    # 240
    layer = 2 * (2 * 10 * 4 * 4)               # fc_self + fc_neigh: 640
    lin_out = 2 * 10 * 4 * 2                   # 160
    agg = 2 * 20 * 2                           # 80
    forward = lin_in + 2 * (layer + agg) + lin_out          # 1840
    backward = lin_in + 2 * (2 * layer + agg) + 2 * lin_out  # 3280
    assert forward == 1840 and backward == 3280
    assert counts.epoch_flops(CONFIG, EDGES) == 2 * forward + backward


@pytest.mark.parametrize("dtype,b", [("float32", 4), ("bfloat16", 2)])
def test_aggregation_floors_by_hand(dtype, b):
    graph = 11 * 4 + 20 * 4                    # row pointers, sources: 124
    fwd = graph + 10 * 2 * (b + 1) + 10 * 4 * b
    bwd = graph + 10 * 4 * b + 10 * 2 * 1 + 10 * 2 * b
    floor = counts.aggregation_floor_s(CONFIG, EDGES, dtype)
    assert floor["forward"] == pytest.approx(fwd / 3.35e12)
    assert floor["backward"] == pytest.approx(bwd / 3.35e12)
    assert counts.epoch_aggregation_floor_s(CONFIG, EDGES, dtype) == \
        pytest.approx((4 * fwd + 2 * bwd) / 3.35e12)


def test_operations_bound_a_wide_k():
    """At k 64 an edge's 128 operations outlast its 4 bytes of source id at
    the f32 peak, so the operations set the floor."""
    config = {"dataset": dict(CONFIG["dataset"]),
              "model": {"hidden_dim": 128, "hidden_layers": 2, "maxk": 64}}
    floor = counts.aggregation_floor_s(config, 10**9, "float32")
    assert floor["forward"] == pytest.approx(2 * 10**9 * 64 / 67e12)


def test_products_epoch_is_8_39_tflop():
    config = {"dataset": {"num_nodes": 2449029, "num_features": 100,
                          "num_classes": 47},
              "model": {"hidden_dim": 256, "hidden_layers": 3, "maxk": 32}}
    assert counts.epoch_flops(config, 123683730) == pytest.approx(8.39e12,
                                                                  rel=2e-3)
