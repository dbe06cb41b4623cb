"""Port parity: corpus-sharded retrieval on a virtual mesh.

The JAX package runs its sharded functions on its 8 forced CPU devices
(Pallas in interpret mode); the port runs its counterparts on a mesh of
`["cpu"] * 8` (the kernel wrappers' plain versions). Inputs are small
integers times powers of two (`exact_inputs`), so every dot product is
exact in f32 and both packages build the same keys: packed keys (as
their quantum-floor decodes), positions, dmax-composed `exact` flags and
f32 values must be equal. Meshes (data x model): (1, 8) and (4, 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.parallel import mesh as port_mesh
from xfmr_rec_torch.parallel import retrieval as port
from xfmr_rec_tpu.parallel import mesh as ref_mesh
from xfmr_rec_tpu.parallel import retrieval as ref

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

MESHES = [(1, 8), (4, 2)]


def meshes(shape):
    data, model = shape
    return (
        ref_mesh.create_mesh(data * model, model_parallel=model),
        port_mesh.create_mesh(model_parallel=model, devices=["cpu"] * 8),
    )


def both(*arrays):
    return (
        [None if a is None else jnp.asarray(a) for a in arrays],
        [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays],
    )


def assert_equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("int8", [False, True])
def test_sharded_topk(shape, int8):
    q, c, scales, _ = exact_inputs(10 + int8, 8, 512, 16, int8=int8)
    rng = np.random.default_rng(1)
    excl = rng.integers(0, 520, size=(8, 5)).astype(np.int32)
    (jq, jc, js, je), (tq, tc, ts, te) = both(
        q, c, None if scales is None else scales[None, :], excl
    )
    if int8:
        jq, tq = jq.astype(jnp.bfloat16), tq.bfloat16()
    jmesh, tmesh = meshes(shape)
    kw = dict(true_num_items=500)
    want = ref.sharded_topk(
        jq, jc, 12, jmesh, exclude_positions=je, scales=js, **kw
    )
    got = port.sharded_topk(
        tq, tc, 12, tmesh, exclude_positions=te, scales=ts, **kw
    )
    assert_equal(got, want)
    assert got[1].dtype == torch.int32
    for row in range(8):
        assert not set(got[1][row].tolist()) & set(excl[row].tolist())


def test_sharded_topk_k_beyond_a_shard():
    """k larger than one shard's rows still merges (local_k = local_n)."""
    q, c, _, _ = exact_inputs(12, 4, 64, 8)
    (jq, jc), (tq, tc) = both(q, c)
    jmesh, tmesh = meshes((1, 8))
    want = ref.sharded_topk(jq, jc, 16, jmesh)
    got = port.sharded_topk(tq, tc, 16, tmesh)
    assert_equal(got, want)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("local_pad", [False, True])
def test_sharded_certified_topk(shape, local_pad):
    # 768 / m rows a shard against a 64-lane tile: (1, 8) leaves 96 rows
    # a shard, padded inside the shard to 128
    n = 768 if local_pad else 1024
    q, c, _, _ = exact_inputs(20 + local_pad, 8, n, 16)
    (jq, jc), (tq, tc) = both(q, c)
    jmesh, tmesh = meshes(shape)
    kw = dict(corpus_tile=64, true_num_items=n - 8)
    want = ref.sharded_certified_topk(jq, jc, 10, jmesh, **kw)
    got = port.sharded_certified_topk(tq, tc, 10, tmesh, **kw)
    np.testing.assert_allclose(
        got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6
    )
    assert_equal(got[1:], want[1:])
    assert got[2].any()


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize(
    "opts",
    [dict(), dict(merge_levels=1), dict(int8=True), dict(n=1000, tni=997)],
    ids=["plain", "merge", "int8", "pad"],
)
def test_sharded_packed_certified_topk(shape, opts):
    n = opts.get("n", 1024)
    q, c, scales, bound = exact_inputs(30, 8, n, 16, int8=opts.get("int8", False))
    (jq, jc, js), (tq, tc, ts) = both(
        q, c, None if scales is None else scales[None, :]
    )
    if scales is not None:
        jq, tq = jq.astype(jnp.bfloat16), tq.bfloat16()
    jmesh, tmesh = meshes(shape)
    kw = dict(
        score_bound=bound, corpus_tile=64, merge_levels=opts.get("merge_levels", 0),
        true_num_items=opts.get("tni"),
    )
    want = ref.sharded_packed_certified_topk(jq, jc, 10, jmesh, scales=js, **kw)
    got = port.sharded_packed_certified_topk(tq, tc, 10, tmesh, scales=ts, **kw)
    assert_equal(got, want)


def planted_collisions(seed, n=1024, ct=64):
    """Exact inputs where four of each planted row's best items sit in
    one lane pair of shard 0 (lanes r and r + ct/2 of its first two
    tiles), so the keep-3 merge drops one, pass 1 cannot certify the row
    and a lane-shuffled retry must."""
    q, c, _, _ = exact_inputs(seed, 16, n, 16)
    for row in range(4):
        for offset in (0, ct // 2, ct, ct + ct // 2):
            c[row + offset] = q[row]
    bound = 2.0 ** np.ceil(np.log2(np.abs(q @ c.T).max() + 1e-3))
    return q, c, float(bound), ct


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("retry_width", [None, 8, (16, 8)])
def test_sharded_packed_guaranteed_topk(shape, retry_width):
    q, c, bound, ct = planted_collisions(40)
    (jq, jc), (tq, tc) = both(q, c)
    jmesh, tmesh = meshes(shape)
    kw = dict(score_bound=bound, corpus_tile=ct, true_num_items=1020)
    pass1 = port.sharded_packed_certified_topk(
        tq, tc, 10, tmesh, merge_levels=1, **kw
    )
    assert not pass1[2][:4].any()  # the planted rows fail pass 1
    want = ref.sharded_packed_guaranteed_topk(
        jq, jc, 10, jmesh, retry_width=retry_width, retries=2, **kw
    )
    got = port.sharded_packed_guaranteed_topk(
        tq, tc, 10, tmesh, retry_width=retry_width, retries=2, **kw
    )
    assert_equal(got, want)
    assert got[2].all()


def test_sharded_guaranteed_int8_and_selectors():
    q, c, scales, bound = exact_inputs(41, 16, 512, 16, int8=True)
    (jq, jc, js), (tq, tc, ts) = both(q.astype(np.float32), c, scales[None, :])
    jmesh, tmesh = meshes((4, 2))
    # 256 lanes: the fused kernel needs a pool a multiple of 128 wide
    kw = dict(score_bound=bound, corpus_tile=256)
    want = ref.sharded_packed_guaranteed_topk(
        jq.astype(jnp.bfloat16), jc, 10, jmesh, scales=js, **kw
    )
    got = port.sharded_packed_guaranteed_topk(
        tq.bfloat16(), tc, 10, tmesh, scales=ts, **kw
    )
    assert_equal(got, want)
    # the fused selector (kernel 5's plain version) finds the same keys
    fused = port.sharded_packed_guaranteed_topk(
        tq.bfloat16(), tc, 10, tmesh, scales=ts, selector="fused", **kw
    )
    assert_equal([fused[0], fused[2]], [want[0], want[2]])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("keep", [2, 3])
def test_sharded_packed_topk_excluding(shape, keep):
    q, c, _, bound = exact_inputs(50 + keep, 8, 1000, 16)
    rng = np.random.default_rng(keep)
    excl = rng.integers(0, 1010, size=(8, 6)).astype(np.int32)
    (jq, jc, je), (tq, tc, te) = both(q, c, excl)
    jmesh, tmesh = meshes(shape)
    kw = dict(score_bound=bound, corpus_tile=64, merge_keep=keep, true_num_items=995)
    want = ref.sharded_packed_topk_excluding(
        jq, jc, 12, jmesh, exclude_positions=je, **kw
    )
    got = port.sharded_packed_topk_excluding(
        tq, tc, 12, tmesh, exclude_positions=te, **kw
    )
    assert_equal(got, want)
    for row in range(8):
        keep_pos = got[1][row][torch.isfinite(got[0][row])].tolist()
        assert not set(keep_pos) & set(excl[row].tolist())
        assert max(keep_pos) < 995


def test_excluding_pool_overflow_raises_like_the_reference():
    q, c, _, bound = exact_inputs(60, 8, 512, 16)
    excl = np.zeros((8, 200), np.int32)
    (jq, jc, je), (tq, tc, te) = both(q, c, excl)
    jmesh, tmesh = meshes((1, 8))
    kw = dict(score_bound=bound, corpus_tile=16)
    with pytest.raises(ValueError, match="per-shard packed candidate pool") as want:
        ref.sharded_packed_topk_excluding(jq, jc, 10, jmesh, exclude_positions=je, **kw)
    with pytest.raises(ValueError, match="per-shard packed candidate pool") as got:
        port.sharded_packed_topk_excluding(tq, tc, 10, tmesh, exclude_positions=te, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "rows,k,match",
    [(1001, 5, "% mesh 'model' != 0"), (64, 80, "exceeds the merged candidate pool")],
    ids=["indivisible", "k-beyond-pool"],
)
def test_geometry_errors_word_for_word(rows, k, match):
    q, c, _, _ = exact_inputs(61, 8, rows, 8)
    (jq, jc), (tq, tc) = both(q, c)
    jmesh, tmesh = meshes((1, 8))
    with pytest.raises(ValueError, match=match) as want:
        ref.sharded_topk(jq, jc, k, jmesh)
    with pytest.raises(ValueError, match=match) as got:
        port.sharded_topk(tq, tc, k, tmesh)
    assert str(got.value) == str(want.value)


def test_query_split_over_the_data_axis():
    """(4, 2): a batch the data axis divides splits (auto), one it does
    not divide is replicated; forcing the split on it raises."""
    q, c, _, _ = exact_inputs(62, 6, 256, 8)
    tmesh = meshes((4, 2))[1]
    assert port._query_spec(tmesh, 8, None) == 4
    assert port._query_spec(tmesh, 6, None) == 1
    assert port._query_spec(tmesh, 8, False) == 1
    with pytest.raises(ValueError, match="pad the batch"):
        port._query_spec(tmesh, 6, True)
    s1, p1 = port.sharded_topk(torch.from_numpy(q), torch.from_numpy(c), 5, tmesh)
    dense = torch.from_numpy(q) @ torch.from_numpy(c).T
    want = torch.sort(dense, dim=1, descending=True, stable=True)
    torch.testing.assert_close(s1, want.values[:, :5], rtol=0, atol=0)


def test_create_mesh_errors():
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        port_mesh.create_mesh(6, model_parallel=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="devices="):
        port_mesh.create_mesh(16, model_parallel=2, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        # no card visible and no devices=: refused, not a CPU mesh
        with pytest.raises(ValueError, match="visible cards"):
            port_mesh.create_mesh(model_parallel=1)
    mesh = port_mesh.create_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.distinct() == [torch.device("cpu")]
