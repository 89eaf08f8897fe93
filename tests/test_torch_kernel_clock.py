"""The pure helpers of chip_smoke.py's kernel clock, on hand-made
entries: rule 2's order, the bound, the L2 flush's size and the check of
bounds that read faster than the card allows."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def entry(name, ms, bound_ms, launches=1, library_ms=None):
    return dict(name=name, ms=ms, bound_ms=bound_ms, launches=launches,
                library_ms=library_ms)


def test_rank_puts_slower_than_library_first_by_factor():
    entries = [entry("gap_big", 10.0, 0.1, launches=100),
               entry("slow_1_2", 1.2, 0.1, library_ms=1.0),
               entry("slow_2_4", 0.048, 0.008, library_ms=0.02),
               entry("fast_lib", 0.5, 0.01, launches=3, library_ms=0.9)]
    order = cs.rank_kernels(entries)
    assert [r[0] for r in order] == ["slow_2_4", "slow_1_2", "gap_big",
                                     "fast_lib"]
    assert [r[1] for r in order] == ["factor", "factor", "gap", "gap"]
    assert order[0][2] == pytest.approx(2.4)
    assert order[1][2] == pytest.approx(1.2)
    assert order[2][2] == pytest.approx(100 * 9.9)
    assert order[3][2] == pytest.approx(3 * 0.49)


def test_rank_orders_the_rest_by_launches_times_gap():
    entries = [entry("a", 1.0, 0.1, launches=2),         # 1.8
               entry("b", 0.3, 0.1, launches=100),       # 20
               entry("c", 5.0, 0.5, launches=1),         # 4.5
               entry("d", 0.2, 0.05, launches=116)]      # 17.4
    assert [r[0] for r in cs.rank_kernels(entries)] == ["b", "d", "c", "a"]


def test_rank_leaves_out_kernels_within_twice_their_bound():
    entries = [entry("at_half", 0.2, 0.1, launches=1000, library_ms=0.2),
               entry("near", 0.15, 0.1, launches=1000),
               entry("past_half", 0.21, 0.1, launches=1)]
    assert [r[0] for r in cs.rank_kernels(entries)] == ["past_half"]


def test_rank_without_library_is_by_gap_alone():
    # no library call: never in the first group, however slow
    entries = [entry("nolib", 100.0, 1.0, launches=1),
               entry("lib_slower", 0.011, 0.001, library_ms=0.01)]
    order = cs.rank_kernels(entries)
    assert order[0][:2] == ("lib_slower", "factor")
    assert order[1][:2] == ("nolib", "gap")
    assert order[1][2] == pytest.approx(99.0)


def test_rank_a_kernel_slower_than_its_call_but_near_its_bound():
    # slower than the library call: ranked by its factor even at its bound
    order = cs.rank_kernels([entry("k", 0.11, 0.1, library_ms=0.1)])
    assert order == [("k", "factor", pytest.approx(1.1))]


def test_bound_is_the_larger_of_bytes_and_operations():
    b = cs.bound(int(3.35e9), 0.0, cs.F32_OPS)
    assert b == dict(bound_ms=pytest.approx(1.0), bound_by="bytes")
    b = cs.bound(int(3.35e9), 2 * 67e9, cs.F32_OPS)
    assert b == dict(bound_ms=pytest.approx(2.0), bound_by="operations")
    b = cs.bound(0, 34e9, cs.F64_OPS)
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "operations"
    # a tie goes to the bytes
    assert cs.bound(int(3.35e9), 33.5e9, cs.I32_OPS)["bound_by"] == "bytes"


def test_flush_is_at_least_twice_the_l2():
    assert cs.L2_BYTES >= 50 * 10 ** 6
    assert cs.FLUSH_BYTES >= 2 * 50 * 10 ** 6
    assert cs.FLUSH_BYTES >= 2 * cs.L2_BYTES


def test_over_bound_names_entries_faster_than_the_card():
    entries = [entry("ok", 0.1, 0.1),
               entry("at_limit", 0.1, 0.105),
               entry("fast", 0.1, 0.1051),
               entry("far", 0.01, 0.1)]
    assert cs.BOUND_LIMIT == 1.05
    assert cs.over_bound(entries) == ["fast", "far"]
    assert cs.over_bound(entries, limit=20.0) == []


def test_gather_bytes_count_the_selected_columns():
    import torch
    src = torch.zeros((2, 5, 10), dtype=torch.int16)
    # row 0: columns 1, 1, 9 and -1 (wraps to 9): 2 distinct; row 1: 3, 4
    # and two out of range (read as the minimum, no source byte)
    cols = torch.tensor([[1, 1, 9, -1], [3, 4, 10, -11]], dtype=torch.int32)
    assert cs.gather_bytes(src, cols) == (2 + 2) * 5 * 2 + cols.numel() * 4
