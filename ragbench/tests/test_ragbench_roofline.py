"""The yardstick's byte and operation counts against hand counts."""

import pytest

from ragbench import roofline


def test_bound_takes_the_longer_limit():
    t, by = roofline.bound(3.35e12, 1.0, "bfloat16")
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound(1.0, 989e12, "bfloat16")
    assert t == pytest.approx(1.0) and by == "operations"


def test_scan_counts_live_rows_once():
    # 32 queries against 8,841,823 live rows of 768 bf16, shared bias, k 10
    nbytes, ops = roofline.scan_work(32, 8_841_823, 768, 10,
                                     dtype="bfloat16", bias="shared")
    rows = 8_841_823 * 768 * 2
    assert nbytes == rows + 32 * 768 * 2 + 8_841_823 * 4 + 32 * 10 * 8
    assert ops == 2 * 32 * 8_841_823 * 768
    # the scan of BASELINE config 3: about 4.05 ms at 3.35 TB/s
    assert roofline.bound(nbytes, ops, "bfloat16")[0] == pytest.approx(
        4.07e-3, rel=0.01)


def test_per_query_bias_is_read_per_query():
    shared, _ = roofline.scan_work(4, 1000, 8, 5, dtype="bfloat16",
                                   bias="shared")
    per, _ = roofline.scan_work(4, 1000, 8, 5, dtype="bfloat16",
                                bias="per_query")
    assert per - shared == 3 * 1000 * 4


def test_encoder_flops_by_hand():
    # one sequence of 10 tokens, one layer, H 4, F 8:
    # projections 2*10*(4*4*4 + 2*4*8) = 2560, attention 2*2*10*10*4 = 1600
    assert roofline.encoder_flops([10], hidden=4, layers=1,
                                  intermediate=8) == 2560 + 1600
    # MiniLM-L6 at 128 tokens: about 2 * 21.3M * 128 FLOPs and attention
    f = roofline.encoder_flops([128], hidden=384, layers=6, intermediate=1536)
    assert f == pytest.approx(6 * (2 * 128 * (4 * 384 ** 2 + 2 * 384 * 1536)
                                   + 4 * 128 * 128 * 384))
