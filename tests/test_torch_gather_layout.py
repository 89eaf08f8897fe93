"""K5's launch (ops/senscore_torch.gather_cols_layout, the Python copy
of csrc/gather_cols.cu's; tests/test_torch_gpu.py holds the two against
each other on the card): a thread a column, the block the row's columns
rounded up to a warp (every lane busy at the paths' S = 288), at most
1,024 threads and then columns in passes, 8 frames a block, a block a
row's frames."""

import pytest

from soundswallower_tpu_torch.ops import senscore_torch as st


def test_paths_shapes():
    """The union route's 128-row chunk and the dense route's B=32 batch
    (S = 288 at T = 320): 9 full warps, one pass, 40 blocks a row; the
    parent's 256 threads took two passes there, 32 lanes busy in the
    second."""
    assert st.gather_cols_layout(128, 320, 288) == dict(
        threads=288, frames=8, passes=1, blocks=128 * 40)
    assert st.gather_cols_layout(32, 320, 288) == dict(
        threads=288, frames=8, passes=1, blocks=32 * 40)


@pytest.mark.parametrize("S,threads,passes", [
    (1, 32, 1), (31, 32, 1), (32, 32, 1), (33, 64, 1), (290, 320, 1),
    (1024, 1024, 1), (1025, 1024, 2), (39552, 1024, 39)])
def test_threads_are_the_columns_to_a_warp(S, threads, passes):
    """Threads: S rounded up to 32, at most GATHER_MAX_THREADS; past it
    each thread takes a column a pass."""
    lay = st.gather_cols_layout(2, 17, S)
    assert (lay["threads"], lay["passes"]) == (threads, passes)
    assert lay["threads"] % 32 == 0 and lay["threads"] <= \
        st.GATHER_MAX_THREADS
    assert lay["threads"] * lay["passes"] >= S > \
        lay["threads"] * (lay["passes"] - 1)


@pytest.mark.parametrize("T,tiles", [(1, 1), (7, 1), (8, 1), (9, 2),
                                     (320, 40), (6656, 832)])
def test_a_block_takes_eight_frames(T, tiles):
    """Blocks: a row's frames in runs of GATHER_FRAMES, the last one
    short where T is not a multiple."""
    assert st.GATHER_FRAMES == 8
    assert st.gather_cols_layout(3, T, 288)["blocks"] == 3 * tiles
