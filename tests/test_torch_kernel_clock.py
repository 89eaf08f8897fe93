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


def test_k3_ops_count_the_chains_own_work():
    # a stream of top-1: the first term's add and the sum over streams
    assert cs.k3_ops(1, 1, 1, 1, False) == 2
    # each later term: add, min, |diff| (two), the table's subtraction
    assert cs.k3_ops(1, 1, 1, 4, False) == 2 + 3 * 5
    # wrap_u8: & 0xFF on every term
    assert cs.k3_ops(1, 1, 1, 4, True) == 2 + 3 * 5 + 4
    # per (frame, state, stream)
    assert cs.k3_ops(10, 174, 3, 4, False) == 10 * 174 * 3 * 17


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


def test_sector_bytes_count_the_touched_sectors():
    """K5's sector floor reads each 32-byte sector its in-range columns
    touch, once, whatever the frame they lie in: int16 frames of 20
    bytes share sectors across frames."""
    import torch
    src = torch.zeros((1, 3, 10), dtype=torch.int16)
    src_ptr = src.data_ptr() % 32
    cols = torch.tensor([[0, 9, -1, 10]], dtype=torch.int32)  # 9 twice
    el = [t * 10 + c for t in range(3) for c in (0, 9)]
    want = len({(e * 2 + src_ptr) // 32 for e in el}) * 32
    assert cs.sector_bytes(src, cols) == want
    src = torch.zeros((2, 2, 64), dtype=torch.int32)
    cols = torch.tensor([[0, 1, 8], [63, -64, 64]], dtype=torch.int32)
    # row 0: columns 0, 1, 8 of each frame; row 1: 63 and 0 (-64 wraps)
    off = src.data_ptr() % 32
    el = [(b * 2 + t) * 64 + c for b, cs_ in ((0, (0, 1, 8)), (1, (63, 0)))
          for t in range(2) for c in cs_]
    assert cs.sector_bytes(src, cols) == len(
        {(e * 4 + off) // 32 for e in el}) * 32


def test_gather_bytes_count_the_selected_columns():
    import torch
    src = torch.zeros((2, 5, 10), dtype=torch.int16)
    # row 0: columns 1, 1, 9 and -1 (wraps to 9): 2 distinct; row 1: 3, 4
    # and two out of range (read as the minimum, no source byte)
    cols = torch.tensor([[1, 1, 9, -1], [3, 4, 10, -11]], dtype=torch.int32)
    assert cs.gather_bytes(src, cols) == (2 + 2) * 5 * 2 + cols.numel() * 4


def _all_entries():
    """Every entry name of the kernels line and every path its counts
    are read from."""
    names = ([k[0] for k in cs.KERNELS] + [v[0] for v in cs.VARIANTS]
             + [f[0] for f in cs.FORMS])
    paths = (set(cs.PATH_OF.values())
             | {v[3] for v in cs.VARIANTS if len(v) > 3}
             | {p for f in cs.FORMS for p in cs.form_paths(f[3])})
    return names, paths


def test_two_forms_of_one_kernel_on_one_path_give_two_counts():
    """The long-form path launches K4's carry form in two forms: the
    int16 shared one (a launch a rank over the 4-row batch on rings of 8
    and 1, and the 5-minute row's own launches) and the int32 global one
    (the large grammar's 8 rows a launch, and the single-utterance
    checks of its rows).  Each entry reads its own form's count at the
    rows and phones it was timed at: a shape the path no longer launches
    reads 0, and the checks count on the single-utterance entry, with
    the large path's launch of it."""
    names, paths = _all_entries()
    results = {n: dict(ms=1.0, bound_ms=0.1) for n in names}
    for name, shape in (("viterbi_chunk[long form, 8 ranks]", "R=1, P=1238"),
                        ("viterbi_chunk[long form, ring step]", "R=4, P=1238"),
                        ("viterbi_chunk[long form, 5-minute row]",
                         "R=1, P=5899"),
                        ("viterbi_chunk[3-state, int32, global, long form]",
                         "R=8, P=13159"),
                        ("viterbi_chunk[3-state, int32, global]",
                         "R=1, P=13159")):
        results[name]["shape"] = shape
    counts = {p: {} for p in paths}
    counts["longform"] = {
        "viterbi_chunk": 33, "viterbi_chunk[3-state]": 17,
        "viterbi_chunk[3-state, R=4, P=1238]": 9,
        "viterbi_chunk[3-state, R=1, P=5899]": 8,
        "viterbi_chunk[3-state, int32, global]": 16,
        "viterbi_chunk[3-state, int32, global, R=8, P=13159]": 8,
        "viterbi_chunk[3-state, int32, global, R=1, P=13159]": 8}
    counts["large"] = {
        "viterbi_chunk": 1, "viterbi_chunk[3-state, int32, global]": 1,
        "viterbi_chunk[3-state, int32, global, R=1, P=13159]": 1}
    got = {e["name"]: e["launches"]
           for e in cs.kernel_entries(counts, results)}
    assert len(got) == len(names)
    assert got["viterbi_chunk[long form, 8 ranks]"] == 0
    assert got["viterbi_chunk[long form, ring step]"] == 9
    assert got["viterbi_chunk[long form, 5-minute row]"] == 8
    assert got["viterbi_chunk[3-state, int32, global, long form]"] == 8
    assert got["viterbi_chunk[3-state, int32, global]"] == 9
    # an entry without a recorded shape reads its form's whole count
    del results["viterbi_chunk[3-state, int32, global, long form]"]["shape"]
    got = {e["name"]: e["launches"]
           for e in cs.kernel_entries(counts, results)}
    assert got["viterbi_chunk[3-state, int32, global, long form]"] == 16


def test_before_takes_only_the_declarations_it_calls():
    """--before DIR calls DIR's K11 with the parameters BEFORE_PARAMS
    lists (its launcher's C signature, this tree's too), typed as DIR's
    header declares them; a header that declares it otherwise, or a
    scalar of a type the harness does not pass, is refused."""
    import ctypes

    ints = {"N", "C", "F", "D", "L", "ne"}

    def decl(name, elem="int"):
        params = cs.BEFORE_PARAMS[name].split()
        return (f"int {name}(" + ", ".join(
            ("cudaStream_t " if p == "stream" else
             f"{elem} " if p == "ne" else
             "int " if p in ints else "const float* ") + p
            for p in params) + ");\n")

    header = "".join(decl(n) for n in cs.BEFORE_PARAMS)
    sigs = cs.before_argtypes(header)
    P, I = ctypes.c_void_p, ctypes.c_int
    assert sigs == {"sst_ms_dist_topn": [P] * 6 + [I] * 6 + [P]}
    assert cs.BEFORE_SOURCES == ("senscore", "ms_senscore")
    with open(os.path.join(REPO, "soundswallower_tpu_torch", "csrc",
                           "sst_kernels.h")) as f:
        assert cs.before_argtypes(f.read()) == sigs
    # a parameter list that differs (no stream), a scalar the harness
    # cannot type, a missing declaration
    with pytest.raises(ValueError, match="sst_ms_dist_topn is declared"):
        cs.before_argtypes(header.replace(", cudaStream_t stream", ""))
    with pytest.raises(ValueError, match="ne of type char"):
        cs.before_argtypes(decl("sst_ms_dist_topn", "char"))
    with pytest.raises(ValueError, match="no declaration"):
        cs.before_argtypes(header.replace("sst_ms_dist_topn", "sst_ms"))


def test_feat_bytes_count_the_frames_read():
    """K1's bound reads each row's frames up to min(max(n, 1), T) (frame
    0 for a row of none, T for a count past it) from both byte planes or
    the float32 cepstra, and the counts: not the padded [B, T] frames."""
    import torch

    n = torch.tensor([10, 4, 0, 25], dtype=torch.int32)
    frames = 10 + 4 + 1 + 10
    planes = torch.zeros((2, 4, 10, 13), dtype=torch.uint8)
    assert cs.feat_bytes(planes, n) == frames * 13 * 2 + 16
    cep = torch.zeros((4, 10, 13), dtype=torch.float32)
    assert cs.feat_bytes(cep, n) == frames * 13 * 4 + 16
    # the long form's 4 rows (62.5-62.8 s: 6,249-6,276 frames of 6,656)
    n = torch.tensor([6249, 6276, 6260, 6270], dtype=torch.int32)
    planes = torch.zeros((2, 4, 6656, 13), dtype=torch.uint8)
    assert cs.feat_bytes(planes, n) == (6249 + 6276 + 6260 + 6270) * 26 + 16


def test_k1_entries_count_launches_at_their_shape():
    """K1's long-form and align entries read their kernel's launches at
    the rows and frames they were timed at (``feat.shapes``,
    ``feat_f32.shapes``) on their paths: the ring of 8's 4 rows, the
    5-minute row, align's one row; the batch entries keep their path's
    whole count."""
    names, paths = _all_entries()
    results = {n: dict(ms=1.0, bound_ms=0.1) for n in names}
    results["feat[long form]"]["shape"] = "B=4, T=6656"
    results["feat[long form, 5-minute row]"]["shape"] = "B=1, T=30208"
    results["feat_f32[align]"]["shape"] = "B=1, T=384"
    counts = {p: {} for p in paths}
    counts["host-FE"] = {"feat": 17, "feat[B=128, T=320]": 4,
                         "feat[B=8, T=320]": 13}
    counts["longform"] = {"feat": 5, "feat[B=4, T=6656]": 1,
                          "feat[B=4, T=6336]": 1, "feat[B=8, T=6336]": 1,
                          "feat[B=1, T=30208]": 1, "feat[B=8, T=29952]": 1}
    counts["device-FE"] = {"feat_f32": 11, "feat_f32[B=128, T=320]": 4,
                           "feat_f32[B=1, T=384]": 1,
                           "feat_f32[B=8, T=320]": 6}
    got = {e["name"]: e["launches"]
           for e in cs.kernel_entries(counts, results)}
    assert got["feat[long form]"] == 1
    assert got["feat[long form, 5-minute row]"] == 1
    assert got["feat_f32[align]"] == 1
    assert got["feat"] == 17 and got["feat_f32"] == 11
    assert [v[3] for v in cs.VARIANTS if v[0] in (
        "feat[long form]", "feat[long form, 5-minute row]",
        "feat_f32[align]")] == ["longform", "longform", "device-FE"]


def test_entries_count_launches_at_their_shape():
    """An entry whose result records the frames and states it was timed
    at (``shape``) reads its kernel's launches at that shape on its path
    (``fn.shapes``): the ms chunk entries the path's chunks, the slice
    entries 0, K3's full-inventory chunk the dense route's; an entry
    without one reads the kernel's whole count.  K13's own entry counts
    its int16 launches only."""
    names, paths = _all_entries()
    results = {n: dict(ms=1.0, bound_ms=0.1) for n in names}
    for name, shape in (("ms_dist_topn", "N=2048, S=5126"),
                        ("ms_senone_eval", "N=2048, S=5126"),
                        ("ms_dist_topn[chunk]", "N=40960, S=5126"),
                        ("ms_senone_eval[chunk]", "N=40960, S=5126"),
                        ("senone_eval[full inventory]", "N=2048, S=5126"),
                        ("senone_eval[full inventory, chunk]",
                         "N=10240, S=5126")):
        results[name]["shape"] = shape
    counts = {p: {} for p in paths}
    counts["backends"] = {
        "ms_dist_topn": 9, "ms_senone_eval": 9,
        "ms_dist_topn[N=40960, S=5126]": 8, "ms_dist_topn[N=9600, S=5126]": 1,
        "ms_senone_eval[N=40960, S=5126]": 8,
        "ms_senone_eval[N=9600, S=5126]": 1}
    counts["host-FE"] = {"senone_eval": 17,
                         "senone_eval[N=10240, S=5126]": 2,
                         "senone_eval[N=40960, S=174]": 15}
    counts["longform"] = {"backtrace_chunk": 25,
                          "backtrace_chunk[int16]": 17,
                          "backtrace_chunk[int32]": 8}
    got = {e["name"]: e["launches"]
           for e in cs.kernel_entries(counts, results)}
    assert got["ms_dist_topn[chunk]"] == got["ms_senone_eval[chunk]"] == 8
    assert got["ms_dist_topn"] == got["ms_senone_eval"] == 0
    assert got["senone_eval[full inventory, chunk]"] == 2
    assert got["senone_eval[full inventory]"] == 0
    assert got["senone_eval"] == 17
    assert got["backtrace_chunk"] == got["backtrace_chunk[int16]"] == 17
    assert got["backtrace_chunk[int32]"] == 8
    # rule 2 ranks the chunk entries, not the slices counted 0 times
    ranked = cs.rank_kernels([e for e in cs.kernel_entries(counts, results)
                              if e["name"].startswith("ms_")])
    assert [n for n, _, _ in ranked[:2]] == ["ms_dist_topn[chunk]",
                                             "ms_senone_eval[chunk]"]
    assert all(v == 0 for _, _, v in ranked[2:])
    # the forced K11/K12 forms count on no path
    for name in ("ms_dist_topn[tile remainder]", "ms_dist_topn[topn 8]",
                 "ms_senone_eval[topn 8]", "ms_senone_eval[aw 2]"):
        assert got[name] == 0


def test_rows_bytes_count_the_real_list_entries():
    """K6's bound reads each phone's real predecessors in its form's
    lists (the band's where the stack has one), not the padded tables."""
    import numpy as np

    from soundswallower_tpu_torch.ops import align_torch as at

    pi, pp, pk = at.build_pred_table([0, 1, 2, 0], [1, 2, 2, 3],
                                     [0, -1, -2, -3], 4, k_pad=33)
    st = dict(tp=np.zeros((1, 4, 3, 4), np.int32), pred_idx=pi[None],
              pred_pen=pp[None], pred_ok=pk[None],
              astart=np.zeros((1, 4), np.int32),
              aend=np.ones((1, 4), np.int32),
              entry=np.zeros((1, 4), np.int32),
              final_mask=np.zeros((1, 4), bool))
    base = 4 * (48 + 4 + 4 + 4 + 4) + 4
    v = at.row_consts_from_numpy(st)
    assert v.pred_n.tolist() == [[0, 1, 2, 1]]
    assert cs.rows_bytes(v) == base + 8 * 4
    W = 4
    st["band_pen"] = np.full((1, W, 4), -(1 << 30), np.int32)
    st["band_ok"] = np.zeros((1, W, 4), bool)
    for src, dst, pen in ((0, 1, 0), (1, 2, -1), (0, 3, -3)):
        st["band_pen"][0, W - (dst - src), dst] = pen
        st["band_ok"][0, W - (dst - src), dst] = True
    v = at.row_consts_from_numpy(st)
    assert v.lists()[0] == "band" and v.band_n.tolist() == [[0, 1, 1, 1]]
    assert cs.rows_bytes(v) == base + 8 * 3


def test_k6_layouts_read_from_a_path_s_counts():
    """The layouts of a path's K6 launches from its counts, not its
    forms or tables, a layout counted 0 left out; none where the path
    launched no K6.  The large path must take its two clusters."""
    counts = {"viterbi_rows": 3, "viterbi_rows[3-state, scores]": 1,
              "viterbi_rows[band]": 2, "viterbi_rows[K-slot]": 1,
              "viterbi_rows[block]": 1, "viterbi_rows[cluster 8]": 2,
              "viterbi_rows[global memory]": 0, "dist_topn_norm[64]": 3}
    assert cs.k6_layouts(counts) == {"block", "cluster 8"}
    assert cs.k6_layouts({"dist_topn_norm[16]": 2}) == set()
    assert cs.K6_LAYOUTS["large"] == {"cluster 4", "cluster 8"}


def test_k4c_layouts_read_from_a_path_s_counts():
    """The layouts of a path's carry-form launches from its counts, not
    its forms or shapes, a layout counted 0 left out; none where the
    path launched no carry form.  The long form must take one block for
    its 4-row batch and clusters for its 5-minute row and the large
    grammar (8 and 16 blocks), the large path a cluster of 16."""
    counts = {"viterbi_chunk": 4, "viterbi_chunk[3-state]": 3,
              "viterbi_chunk[3-state, int32, global]": 1,
              "viterbi_chunk[3-state, R=4, P=1238]": 2,
              "viterbi_chunk[block]": 3, "viterbi_chunk[cluster 8]": 1,
              "viterbi_chunk[global memory]": 0,
              "viterbi_rows[cluster 4]": 2}
    assert cs.k4c_layouts(counts) == {"block", "cluster 8"}
    assert cs.k6_layouts(counts) == {"cluster 4"}
    assert cs.k4c_layouts({"viterbi_rows[block]": 2}) == set()
    assert cs.K4C_LAYOUTS["longform"] == {"block", "cluster 8",
                                          "cluster 16"}
    assert cs.K4C_LAYOUTS["large"] == {"cluster 16"}


def test_vit_bytes_count_the_real_slots():
    """K4's bound reads each phone's real predecessor slots, not the
    padded [P, K] tables or pred_ok."""
    import numpy as np

    from soundswallower_tpu_torch.ops import align_torch as at

    pi, pp, pk = at.build_pred_table([0, 1, 2, 0], [1, 2, 2, 3], [0, -1, -2,
                                                                  -3], 4,
                                     k_pad=125)
    v = at.graph_consts_from_numpy(dict(
        tp=np.zeros((4, 3, 4), np.int32), pi=pi, pp=pp, pk=pk,
        ast=np.zeros(4, np.int32), aen=np.ones(4, np.int32),
        entry=np.zeros(4, np.int32), fin=np.array([3], np.int32)))
    assert v.pred_n.tolist() == [0, 1, 2, 1]
    assert cs.vit_bytes(v) == 4 * (48 + 4 + 4 + 4 + 4 + 1) + 8 * 4


def test_rule_two_takes_k5_next():
    """Rule 2 on the entries of K1, K14 and K5 as the card measured them
    after K1's and K14's redesign (chip_smoke.py, NVIDIA H100 80GB HBM3,
    700.00 W; launches, ms, bound ms, library ms).  Leaving out the
    wrappers of the kernels ROADMAP lists as redesigned (K1 and K14
    among them), K5 is the next slice, by its `[int16 full inventory]`
    entry alone (its base entry runs within twice its bound); with them,
    K1 and K14 entries still come first."""
    measured = [
        ("feat", 18, 0.017216, 0.002202, None),
        ("feat_f32", 11, 0.024005, 0.004993, None),
        ("feat_f32[wire f32]", 3, 0.012736, 0.000156, None),
        ("feat[long form]", 1, 0.040226, 0.001434, None),
        ("feat[long form, 5-minute row]", 1, 0.125616, 0.001639, None),
        ("feat_f32[align]", 1, 0.012544, 0.000023, None),
        ("yin_cmnd", 4, 0.013648, 0.000265, None),
        ("yin_cmnd[200]", 4, 0.011376, 0.000067, None),
        ("yin_cmnd[1024]", 4, 0.021840, 0.001690, None),
        ("yin_cmnd[4096]", 4, 0.085792, 0.023288, None),
        ("gather_cols", 9, 0.035888, 0.018322, 0.072448),
        ("gather_cols[int16 full inventory]", 9, 0.016112, 0.004056,
         0.026880),
        # a redesigned kernel, however large its gap
        ("viterbi_chunk[long form, 5-minute row]", 8, 45.75, 0.1199, None),
    ]
    entries = [entry(n, ms, b, launches=k, library_ms=lib)
               for n, k, ms, b, lib in measured]
    redesigned = {"feat", "feat_f32", "yin_cmnd", "viterbi_chunk"}
    order = cs.rank_kernels([e for e in entries
                             if e["name"].split("[")[0] not in redesigned])
    assert order == [("gather_cols[int16 full inventory]", "gap",
                      pytest.approx(9 * (0.016112 - 0.004056)))]
    before = cs.rank_kernels([e for e in entries
                              if not e["name"].startswith("viterbi_chunk")])
    assert [n for n, _, _ in before[:4]] == ["feat", "yin_cmnd[4096]",
                                             "feat_f32",
                                             "feat[long form, 5-minute row]"]
    assert before[4][0] == "gather_cols[int16 full inventory]"
