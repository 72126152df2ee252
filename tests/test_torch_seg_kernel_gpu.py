"""The wave body's node-segmented CUDA kernels (`seg_kernel`,
`csrc/seg_kernel.cu`) against their plain torch version, bit for bit, on
the cases of tests/test_torch_seg_conflicts.py: K above 2,048, few, many
and all-same candidate nodes, rows outside the check.  These tests
import neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_seg_kernel_gpu.py

Without a GPU they skip (the kernels have no CPU or interpret mode)."""
import pytest
import torch

from nomad_tpu_torch.solver import seg_kernel as sk
from test_torch_seg_conflicts import (CASES, NP, commit_outputs,
                                      conflict_outputs, helpers, make_case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run on CUDA only)")


@pytest.mark.cuda
@pytest.mark.parametrize("K,layout", CASES)
def test_seg_kernels_equal_the_plain_version(cuda, K, layout):
    """Prior sums, ranks and commits from the kernels equal the plain
    version's on every element, and each call launched."""
    cpu = make_case(K, layout)
    gpu = make_case(K, layout, device="cuda")
    before = sk.LAUNCHES.copy()
    got, segs_g = conflict_outputs(K, gpu, seg=True)
    got.update(commit_outputs(gpu, segs_g))
    torch.cuda.synchronize()
    want, segs_c = conflict_outputs(K, cpu, seg=True)
    want.update(commit_outputs(cpu, segs_c))
    assert torch.equal(segs_g.ix.cpu(), segs_c.ix)
    for name in want:
        assert torch.equal(got[name].cpu(), want[name]), name
    # 2 prior sums, 3 ranks, 2 commit reduces; 3 counts
    assert dict(sk.LAUNCHES - before) == {"scan": 7, "commit": 2, "hist": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["many", "same"])
def test_seg_kernels_past_one_tile(cuda, layout):
    """Past 8,192 rows a thread reads its rows in several tiles: the
    same answers as the plain version."""
    K = 20_000
    cpu = make_case(K, layout)
    gpu = make_case(K, layout, device="cuda")
    got, segs_g = conflict_outputs(K, gpu, seg=True)
    got.update(commit_outputs(gpu, segs_g))
    want, segs_c = conflict_outputs(K, cpu, seg=True)
    want.update(commit_outputs(cpu, segs_c))
    for name in want:
        assert torch.equal(got[name].cpu(), want[name]), name


@pytest.mark.cuda
def test_seg_kernels_wide_columns(cuda):
    """Eleven columns."""
    x = make_case(4096, "many", device="cuda")
    _, _, _, segs = helpers(4096, x, seg=True)
    vals = torch.cat([x["ask"], x["ask"] * 2, x["ask"][:, :3]], dim=1)
    got = [sk.prior_sum(segs, vals),
           sk.seg_add(segs, x["used"].repeat(1, 3)[:, :11], vals,
                      x["commit"])]
    cpu = {k: v.cpu() for k, v in x.items()}
    segs_c = sk.Segments(segs.key.cpu(), segs.ix.cpu())
    assert torch.equal(got[0].cpu(), sk.prior_sum(segs_c, vals.cpu()))
    assert torch.equal(got[1].cpu(), sk.seg_add(
        segs_c, cpu["used"].repeat(1, 3)[:, :11], vals.cpu(),
        cpu["commit"]))
    assert got[1].shape == (NP, 11)


@pytest.mark.cuda
def test_hist_past_shared_memory(cuda):
    """A target wider than the kernel's shared counts takes float
    atomics: the same counts."""
    n = sk.HIST_SMEM_CELLS + 4_000
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(-3, n + 3, (20_000,), generator=g)
    w = torch.rand(20_000, generator=g) < 0.6
    t = torch.randint(0, 50, (n,), generator=g).to(torch.float32)
    got = sk.hist_add(t.cuda(), idx.cuda(), w.cuda())
    assert torch.equal(got.cpu(), sk.hist_add(t, idx, w))
