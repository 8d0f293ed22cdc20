"""The operation and byte counts match counts by hand."""

from ctrbench.harness import spec


def test_dcn_v2_counts():
    m = spec.Bench().config("dcn_v2-ref43")["model"]
    fl = spec.flops("dcn_v2")
    d = 43 * 16
    by_hand = 2 * (3 * d * d + d * 256 + 256 * 128 + 128 * 64 + (d + 64))
    assert fl.flops_per_row(m) == by_hand == 3_275_744
    assert fl.gathered_bytes_per_row(m) == 43 * 16 * 4 == 2752
    ops, nbytes = fl.fused_serve_cost(m, 2048)
    assert ops == 2048 * by_hand
    weights = (3 * d * d + d * 256 + 256 * 128 + 128 * 64 + d + 64) * 2
    biases = (3 * d + 256 + 128 + 64 + 1) * 4
    assert nbytes == weights + biases + 2048 * (43 * 5 + 2752 + 4)
    # PERF.md's bounds of the kernel: ops at 2048 rows, bytes at 256 rows.
    assert abs(ops / 989e12 * 1e3 - 0.00678) < 1e-4
    assert abs(fl.fused_serve_cost(m, 256)[1] / 3.35e12 * 1e3 - 0.00121) < 1e-4


def test_dlrm_counts():
    m = spec.Bench().config("dlrm-mlperf")["model"]
    fl = spec.flops("dlrm")
    pairs = 27 * 26 // 2
    by_hand = 2 * (13 * 512 + 512 * 256 + 256 * 128 + pairs * 128
                   + (128 + pairs) * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    assert fl.flops_per_row(m) == by_hand == 4_820_224
    assert fl.gathered_bytes_per_row(m) == 26 * 128 * 4 == 13312
    assert fl.wire_bytes_per_row(m) == 26 * 5 + 13 * 4
