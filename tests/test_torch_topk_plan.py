"""K5's plan (ops/topk._topk_plan), checked on the CPU over store sizes from
one row to past 2³¹ elements: the kernel takes its grid, row ranges, ring
and shared memory from this plan, so a plan that leaves a row out, loads
one SM with twice another's rows or asks for more shared memory than a
block has would show only on the card."""

import pytest

from hippomm_tpu_torch.ops import topk as ttk


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("k", [1, 20, 128])
@pytest.mark.parametrize("d", [4, 256, 1024])
@pytest.mark.parametrize("n", [1, 130, 1024, 200_000, 1_000_000, 2_200_000])
def test_topk_plan(n, d, k, sm_count):
    if k > n:
        with pytest.raises(ValueError, match="no top-k plan"):
            ttk._topk_plan(n, d, k, sm_count)
        return
    plan = ttk._topk_plan(n, d, k, sm_count)
    assert plan == ttk._topk_plan(n, d, k, sm_count)  # the same for the same input
    # every row in exactly one block's range: the ranges tile [0, n) in order
    ranges = [ttk._block_rows(n, plan.blocks, b) for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [stop - start for start, stop in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= plan.chunk_rows
    assert plan.rows_per_block == min(sizes)
    # a persistent grid: no more blocks than chunks, or than fit on the card
    assert plan.blocks == min(-(-n // plan.chunk_rows), sm_count * plan.blocks_per_sm)
    assert 1 <= plan.blocks_per_sm <= 2
    # shared memory: a block's, and the SM's for its resident blocks
    # (beside the kernel's 128 bytes of static shared memory)
    assert plan.smem_bytes + 256 <= 232_448
    assert plan.blocks_per_sm * (plan.smem_bytes + 256 + 1024) <= 233_472
    assert plan.smem_bytes == ttk._smem_bytes(d, plan.chunk_rows, plan.stages, plan.blocks)
    # the ring: 2-8 slots of whole rows, bulk copies of 16-byte multiples,
    # and enough of it for the merge's 4096 entries
    assert 2 <= plan.stages <= 8 and (4 * d * plan.chunk_rows) % 16 == 0
    assert plan.stages * plan.chunk_rows * 4 * d >= 8 * 4096
    # a chunk's rows fit the candidate buffer behind the list (1024 - k)
    assert 1 <= plan.chunk_rows <= 1024 - 128
    # the scratch buffer holds every block's k candidates
    assert plan.scratch_entries == plan.blocks * k


def test_topk_plan_refuses_what_the_kernel_cannot_take():
    for n, d, k in ((10, 0, 1), (0, 8, 1), (100, 8, 129), (100, 8, 0), (5, 8, 6)):
        with pytest.raises(ValueError, match="no top-k plan"):
            ttk._topk_plan(n, d, k, 132)
    with pytest.raises(ValueError, match="shared memory"):
        ttk._topk_plan(1000, 32_768, 5, 132)


@pytest.mark.parametrize("n", [1, 130, 200_000, 1_000_000])
@pytest.mark.parametrize("d,offset", [(6, 0), (1026, 0), (1024, 1), (1024, 3), (6, 2), (1, 0), (3, 1)])
def test_topk_plan_any_width_and_offset(n, d, offset):
    """Rows of any width and a store view starting any element past a
    16-byte boundary: the element-wise instance (vec False), whose ring
    slots hold a chunk and the 3 floats on either side of it that its
    unaligned head and tail may shift it by, the rows' ranges as above, at
    least the merge's 4096 entries of ring, and the shared memory a block
    and an SM have. D % 4 == 0 at an aligned base keeps the float4 plan."""
    k = min(20, n)
    plan = ttk._topk_plan(n, d, k, 132, offset)
    assert not plan.vec
    assert plan.slot_floats % 4 == 0 and plan.slot_floats >= plan.chunk_rows * d + 3
    ranges = [ttk._block_rows(n, plan.blocks, b) for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.blocks == min(-(-n // plan.chunk_rows), 132 * plan.blocks_per_sm)
    assert plan.smem_bytes == ttk._smem_bytes(d, plan.chunk_rows, plan.stages, plan.blocks, False)
    assert plan.smem_bytes + 256 <= 232_448
    assert plan.blocks_per_sm * (plan.smem_bytes + 256 + 1024) <= 233_472
    assert 1 <= plan.chunk_rows <= 1024 - 128 and 2 <= plan.stages <= 8
    ring = plan.smem_bytes - (-(-4 * d // 16) * 16 + 8 * 1024 + -(-4 * (plan.blocks + 1) // 16) * 16
                              + 16 * plan.stages)
    assert ring >= max(8 * 4096, plan.stages * plan.slot_floats * 4)
    aligned = ttk._topk_plan(n, 1024, k, 132)
    assert aligned.vec and aligned.slot_floats == aligned.chunk_rows * 1024
