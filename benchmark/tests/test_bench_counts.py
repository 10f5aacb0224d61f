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


GCN_PRODUCTS = {"dataset": {"num_nodes": 2449029, "num_features": 100,
                            "num_classes": 47},
                "model": {"model": "gcn", "hidden_dim": 256,
                          "hidden_layers": 3, "maxk": 32}}
# the products stand-in's 123,683,730 edges and a self-loop per node
GCN_EDGES = 123683730 + 2449029


def test_gcn_products_epoch_flops_by_hand():
    # N 2449029, F 100, H 256, C 47, L 3, E 126132759, k 32
    n, e = 2449029, GCN_EDGES
    lin_in = 2 * n * 100 * 256                  # 125,390,284,800
    layer = 2 * n * 256 * 256                   # lin{i}: 320,999,129,088
    lin_out = 2 * n * 256 * 47
    agg = 2 * e * 32                            # 8,072,496,576
    forward = lin_in + 3 * (layer + agg) + lin_out
    backward = lin_in + 3 * (2 * layer + agg) + 2 * lin_out
    assert (forward, backward) == (1171538595648, 2193469416768)
    assert counts.epoch_flops(GCN_PRODUCTS, GCN_EDGES) == 4536546608064


@pytest.mark.parametrize("dtype,b", [("float32", 4), ("bfloat16", 2)])
def test_gcn_products_aggregation_floors_by_hand(dtype, b):
    n, e = 2449029, GCN_EDGES
    # row pointers, sources, and the two f32 degree factors: 533,919,388
    fixed = (n + 1) * 4 + e * 4 + 2 * n * 4
    fwd = fixed + n * 32 * (b + 1) + n * 256 * b
    bwd = fixed + n * 256 * b + n * 32 * 1 + n * 32 * b
    assert fixed == 533919388
    assert fwd == bwd == {4: 3433569724, 2: 2022929020}[b]
    floor = counts.aggregation_floor_s(GCN_PRODUCTS, GCN_EDGES, dtype)
    # bytes bound both: 2·E·k = 8.07 GFLOP is 0.12 ms at the f32 peak
    assert floor == {"forward": fwd / 3.35e12, "backward": bwd / 3.35e12}
    assert counts.epoch_aggregation_floor_s(GCN_PRODUCTS, GCN_EDGES,
                                            dtype) == pytest.approx(
        (6 * fwd + 3 * bwd) / 3.35e12)
