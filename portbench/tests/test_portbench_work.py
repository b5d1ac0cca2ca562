"""The algorithm's byte count against a hand count on a 6-vertex graph."""
import torch

from portbench import ref, work

#  0 -2- 1 -4- 3 -1- 5
#  |   / |
#  5  1  |        (edges 0-1 w2, 0-2 w5, 1-2 w1, 1-3 w4, 2-4 w3, 3-5 w1)
#  | /   |
#  2 -3- 4
ROW_PTR = torch.tensor([0, 2, 5, 8, 10, 11, 12], dtype=torch.int32)
COL_IDX = torch.tensor([1, 2, 0, 2, 3, 0, 1, 4, 1, 5, 2, 3],
                       dtype=torch.int32)
EDGE_W = torch.tensor([2, 5, 2, 1, 4, 5, 1, 3, 4, 1, 3, 1],
                      dtype=torch.int32)


def test_sssp_rounds_and_bytes_by_hand():
    labels, rounds = ref.sssp(ROW_PTR, COL_IDX, EDGE_W, [0])
    assert labels[0].tolist() == [0, 2, 3, 6, 6, 7]
    # round 1: F = {0}, its 2 arcs, labels of 1 and 2 change
    assert rounds[0] == {"f_union": 1, "a_union": 2, "f": [1], "a": [2],
                         "c": [2]}
    # 12 B a frontier vertex + 12 B an arc + 8 B a change
    assert work.min_round_bytes(rounds[0]) == 12 * 1 + 12 * 2 + 8 * 2
    # round 2: F = {1, 2}, 6 arcs; 2 (via 1), 3 and 4 change
    assert rounds[1]["f"] == [2] and rounds[1]["a"] == [6]
    assert rounds[1]["c"] == [3]
    assert work.min_round_bytes(rounds[1]) == 12 * 2 + 12 * 6 + 8 * 3
    assert work.min_query_bytes(rounds) == sum(
        work.min_round_bytes(r) for r in rounds)


def test_bfs_round_reads_no_weight():
    _, rounds = ref.sssp(ROW_PTR, COL_IDX, EDGE_W, [0], weighted=False)
    assert work.min_round_bytes(rounds[0], weighted=False) == \
        12 * 1 + 8 * 2 + 8 * 2


def test_batched_round_shares_arcs_once():
    labels, rounds = ref.sssp(ROW_PTR, COL_IDX, EDGE_W, [0, 5])
    assert labels[1].tolist() == [7, 5, 6, 1, 9, 0]
    # round 1: rows {0} (2 arcs, 2 changes) and {5} (1 arc, 1 change)
    r1 = rounds[0]
    assert (r1["f_union"], r1["a_union"]) == (2, 3)
    assert work.min_round_bytes(r1) == (8 * 2 + 8 * 3
                                        + (4 * 1 + 4 * 2 + 8 * 2)
                                        + (4 * 1 + 4 * 1 + 8 * 1))
    # round 2: rows {1, 2} (6 arcs, 3 changes) and {3} (2 arcs, 1
    # change); the union {1, 2, 3} reads its 8 arcs once
    r2 = rounds[1]
    assert (r2["f_union"], r2["a_union"]) == (3, 8)
    assert (r2["f"], r2["a"], r2["c"]) == ([2, 1], [6, 2], [3, 1])
    assert work.min_round_bytes(r2) == (8 * 3 + 8 * 8
                                        + (4 * 2 + 4 * 6 + 8 * 3)
                                        + (4 * 1 + 4 * 2 + 8 * 1))


def test_pagerank_round_by_hand():
    # row_ptr 4 (V + 1), each arc's id and contribution 8, each vertex's
    # rank and inverse degree read and new rank written 12
    assert work.pagerank_round_bytes(6, 12) == 4 * 7 + 8 * 12 + 12 * 6


def test_pagerank_reference_by_hand():
    rank, deltas = ref.pagerank(ROW_PTR, COL_IDX, 0.85, 0.0, 1)
    deg = torch.tensor([2, 3, 3, 2, 1, 1], dtype=torch.float64)
    nbrs = [[1, 2], [0, 2, 3], [0, 1, 4], [1, 5], [2], [3]]
    want = torch.tensor([0.15 / 6 + 0.85 * sum(1 / 6 / deg[u] for u in nb)
                         for nb in nbrs])
    torch.testing.assert_close(rank.double(), want, rtol=1e-6, atol=0)
    assert len(deltas) == 1
