"""Bit-packed boolean planes and the vectorized constraint ops of the
port against the JAX package: the int32 words carry exactly the
reference's uint32 bit patterns, and `_op_eval` agrees for every op."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.solver import masks as ref_masks
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.solver.kernel import _op_eval as ref_op_eval
from nomad_tpu_torch.solver import masks
from nomad_tpu_torch.solver.kernel import _op_eval


@pytest.mark.parametrize("shape", [(3, 64), (5, 37), (2, 3, 100), (1, 1),
                                   (4, 32)])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_pack_matches_reference_words(shape, p):
    rng = np.random.default_rng(sum(shape) + int(10 * p))
    mask = rng.random(shape) < p
    words = masks.pack_bool_u32(torch.as_tensor(mask))
    assert words.dtype == torch.int32
    want = ref_masks.np_pack_bool_u32(mask)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(ref_masks.pack_bool_u32(jnp.asarray(mask))))
    back = masks.unpack_bool_u32(words, shape[-1])
    np.testing.assert_array_equal(back.numpy(), mask)
    np.testing.assert_array_equal(
        back.numpy(), ref_masks.np_unpack_bool_u32(want, shape[-1]))


def test_unpack_high_bit():
    """Bit 31 (the int32 sign bit) round-trips."""
    mask = np.zeros((1, 64), bool)
    mask[0, 31] = mask[0, 63] = True
    words = masks.pack_bool_u32(torch.as_tensor(mask))
    assert words.numpy().view(np.uint32).tolist() == [[1 << 31, 1 << 31]]
    np.testing.assert_array_equal(
        masks.unpack_bool_u32(words, 64).numpy(), mask)


OPS = [ref_tz.OP_NONE, ref_tz.OP_EQ, ref_tz.OP_NE, ref_tz.OP_LT,
       ref_tz.OP_LE, ref_tz.OP_GT, ref_tz.OP_GE, ref_tz.OP_IS_SET,
       ref_tz.OP_NOT_SET]


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_op_eval_every_op(dtype):
    rng = np.random.default_rng(7)
    N = 50
    vals = rng.integers(-1, 6, (N, len(OPS))).astype(dtype)
    op = np.array(OPS, dtype)
    rank = rng.integers(0, 6, len(OPS)).astype(dtype)
    got = _op_eval(torch.as_tensor(vals), torch.as_tensor(op),
                   torch.as_tensor(rank)).numpy()
    want = np.asarray(ref_op_eval(jnp.asarray(vals), jnp.asarray(op),
                                  jnp.asarray(rank)))
    np.testing.assert_array_equal(got, want)


def test_op_eval_batched_groups():
    """The port evaluates all groups at once ([G, N, C] values, [G, C]
    programs); each group row equals the reference's per-group call."""
    rng = np.random.default_rng(3)
    G, N, C = 4, 33, len(OPS)
    vals = rng.integers(-1, 5, (G, N, C)).astype(np.int16)
    op = np.stack([rng.permutation(OPS) for _ in range(G)]).astype(np.int16)
    rank = rng.integers(0, 5, (G, C)).astype(np.int16)
    got = _op_eval(torch.as_tensor(vals), torch.as_tensor(op),
                   torch.as_tensor(rank)).numpy()
    for g in range(G):
        want = np.asarray(ref_op_eval(jnp.asarray(vals[g]),
                                      jnp.asarray(op[g]),
                                      jnp.asarray(rank[g])))
        np.testing.assert_array_equal(got[g], want)
