"""The port's flash attention and its deployed ``attention`` op against
the JAX package's, on the CPU: the kernel's plain version
(``kernels/ref.py:flash_attention_blocked_ref``) through
``kernels/ops.py:flash_attention``, in f32 and bf16, against the
reference's Pallas body in interpret mode and its softmax oracle, at the
shapes and blocks of ``tests/test_kernels_flash.py``; the reference
wrapper's padding contract, the padded keys under causal S > T
included; and the ``attention`` graph of ``tests/test_fusion_block.py``
deployed by both packages; the kernel's shared-memory plans and kv
split, which are Python. Tolerances: the ``float32`` row of
``tests/_numerics.py`` (``bfloat16`` for bf16 inputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_close

from repro.core.graph_ir import Graph as JGraph
from repro.core.graph_ir import Operator as JOperator
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.pipeline import deploy as jdeploy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.graph_ir import Graph, Operator
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_cuda, fits,
                                                 kv_split, plan_block,
                                                 plan_stages, plan_width,
                                                 smem_bytes)

# (s, t, d, bq, bk) of tests/test_kernels_flash.py, 48 the padded case
SHAPES = [(32, 32, 16, 16, 16), (64, 64, 32, 16, 32), (128, 128, 64, 64, 64),
          (48, 48, 16, 16, 16), (16, 16, 8, 16, 16)]


def _qkv(rng, bh, s, t, d):
    return tuple(rng.normal(size=(bh, n, d)).astype(np.float32)
                 for n in (s, t, t))


def _port(q, k, v, **kw):
    return tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw).numpy()


@pytest.mark.parametrize("s,t,d,bq,bk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference(s, t, d, bq, bk, causal):
    """The port's blocked plain version within the float32 row of the
    reference's Pallas body (interpret mode) and of its oracle."""
    rng = np.random.default_rng(s * 100 + d)
    q, k, v = _qkv(rng, 3, s, t, d)
    got = _port(q, k, v, causal=causal, bq=bq, bk=bk)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, bq=bq, bk=bk,
                                  backend="pallas_interpret")
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
    assert got.shape == (3, s, d)
    assert_close(got, np.asarray(pallas), dtype="float32",
                 context="vs pallas_interpret")
    assert_close(got, np.asarray(oracle), dtype="float32",
                 context="vs oracle")


@pytest.mark.parametrize("causal", [True, False])
def test_port_oracle_matches_reference_oracle(causal):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 24, 40, 8)
    got = tref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal).numpy()
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    assert_close(got, np.asarray(want), dtype="float32")


def test_padded_keys_join_causal_rows_when_s_exceeds_t():
    """S = 40 > T = 24 under causal, bk = 16: T pads to 32, and a padded
    key (score 0, value 0) with an index at most the row's joins that
    row's softmax, as in the reference's wrapper. The port copies this:
    it agrees with the reference's Pallas body on every row, and with
    the oracle only on the rows no padded key reaches (rows < 24)."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 40, 24, 8)
    got = _port(q, k, v, causal=True, bq=16, bk=16)
    pallas = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, bq=16, bk=16,
        backend="pallas_interpret"))
    oracle = np.asarray(jref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=True))
    assert_close(got, pallas, dtype="float32", context="vs pallas")
    assert_close(got[:, :24], oracle[:, :24], dtype="float32",
                 context="rows before the padded keys")
    # rows 24.. take padded keys into their denominators: the output
    # shrinks towards 0 (value 0) against the oracle's
    gap = np.abs(got[:, 24:] - oracle[:, 24:]).max(axis=-1)
    assert (gap > 1e-3).all()


def test_rowsums_one():
    """The softmax invariant: with v = ones the output is ones, within the
    float32 row (the kernel sums l and acc in different orders)."""
    rng = np.random.default_rng(1)
    q, k, _ = _qkv(rng, 2, 32, 32, 16)
    v = np.ones((2, 32, 16), np.float32)
    got = _port(q, k, v, bq=16, bk=16)
    assert_close(got, np.ones_like(got), dtype="float32")


def test_blocks_change_rounding_only():
    """Every candidate block pair computes the same function (within the
    float32 row of each other); the blocks are arguments of the plain
    version because they move the rounding."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 64, 16)
    base = _port(q, k, v, bq=64, bk=64)
    for bq, bk in ((16, 16), (16, 64), (32, 16), (64, 32)):
        assert_close(_port(q, k, v, bq=bq, bk=bk), base, dtype="float32",
                     context=f"bq={bq} bk={bk}")


def test_noncausal_unaligned_t_raises_in_both():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 16, 24, 8)
    with pytest.raises(ValueError, match="T % bk"):
        _port(q, k, v, causal=False, bq=16, bk=16)
    with pytest.raises(ValueError, match="T % bk"):
        jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                             bq=16, bk=16, backend="pallas_interpret")


def test_blocked_ref_refuses_unpadded_shapes():
    q = torch.zeros((1, 24, 8))
    with pytest.raises(ValueError, match="multiples"):
        tref.flash_attention_blocked_ref(q, q, q, bq=16, bk=16)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_version_matches_reference(causal):
    """bf16 q, k, v: the port widens them, computes in f32 and rounds the
    output to bf16, as the reference's Pallas body does; within the
    bfloat16 row of it (interpret mode) on the same bf16 inputs."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 64, 64, 16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal, bq=32, bk=32)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, 16)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = jops.flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32,
                                backend="pallas_interpret")
    assert want.dtype == jnp.bfloat16
    assert_close(got.float().numpy(), np.asarray(want, np.float32),
                 dtype="bfloat16")


def test_cuda_wrapper_refuses_other_dtypes():
    q = torch.zeros((1, 16, 8), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q, q, q, bq=16, bk=16)


def test_cuda_wrapper_never_falls_back_to_the_cpu():
    """The kernel's wrapper takes CUDA tensors only: given CPU tensors
    it raises instead of running the plain version."""
    q = torch.zeros((1, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, bq=16, bk=16)


@pytest.mark.parametrize("bq,bk,d,plan,fit", [
    (128, 128, 128, (128, 128, 128, 1), True),
    (128, 128, 64, (128, 128, 64, 2), True),
    (64, 64, 64, (64, 64, 64, 2), True),
    (256, 64, 128, (128, 64, 128, 2), True),
    (64, 256, 128, (64, 128, 128, 1), True),
    (16, 512, 8, (32, 128, 64, 2), True),
    (128, 128, 160, (128, 128, 128, 1), False),
    (0, 64, 64, (32, 64, 64, 2), False)])
def test_shared_memory_plan(bq, bk, d, plan, fit):
    """The plan the kernel's source allocates for a request: tiles of 32,
    64 or 128 rows and keys, the head width laid out as 64 or 128; the Q
    tile and the K tiles at row stride D + 4, the V tiles, and 32 keys
    of p at row stride BQ + 4, all f32, with two K/V stages where they
    fit 227 KB, else one. Refused for a d above 128 or a block below 1."""
    pq, pk, dp, stages = plan
    assert (plan_block(bq), plan_block(bk), plan_width(d),
            plan_stages(bq, bk, d)) == plan
    assert smem_bytes(bq, bk, d) == 4 * (pq * (dp + 4)
                                         + stages * pk * (dp + 4)
                                         + stages * pk * dp
                                         + 32 * (pq + 4))
    assert fits(bq, bk, d) is fit


@pytest.mark.parametrize("shape,blocks,want", [
    ((8, 512, 512), (128, 128), (1, 4)),     # 32 q tiles: 4 splits
    ((8, 512, 512), (64, 64), (4, 2)),       # 64 q tiles: 2 splits
    ((8, 512, 512), (32, 64), (8, 1)),       # 128 q tiles fill the SMs
    ((16, 4096, 4096), (128, 128), (32, 1)),
    ((1, 64, 1000), (64, 32), (2, 16)),      # at most 16 splits
    ((1, 16, 16), (16, 16), (1, 1))])        # one kv tile
def test_kv_split_fills_the_sms(shape, blocks, want):
    """(chunk, nsplit) on a card of 132 SMs: the kv tiles of a q tile are
    split over CTAs only while the q tiles are fewer than the SMs."""
    bh, s, t = shape
    bq, bk = blocks
    assert kv_split(bh, s, t, bq=bq, bk=bk, n_sm=132) == want


# ------------------------------------------------------------- deployment ----
def _attention_graphs(n=16, d=8, seed=0):
    """The `_attention_graph` of tests/test_fusion_block.py, built in both
    packages from the same numpy weights."""
    rng = np.random.default_rng(seed)
    ws = {nm: (rng.normal(size=(d, d)) * 0.3).astype(np.float32)
          for nm in ("q", "k", "v")}
    jg, tg = JGraph(), Graph()
    for G, Op, arr in ((jg, JOperator, jnp.asarray),
                       (tg, Operator, torch.from_numpy)):
        G.add(Op(name="tok", op_type="input", out_dim=d,
                 attrs={"feature": "tok"}))
        for nm in ("q", "k", "v"):
            G.add(Op(name=nm, op_type="linear", inputs=["tok"],
                     params={"w": arr(ws[nm]),
                             "b": arr(np.zeros((d,), np.float32))},
                     out_dim=d))
        G.add(Op(name="attn", op_type="attention", inputs=["q", "k", "v"],
                 attrs={"causal": True}, out_dim=d))
        G.add(Op(name="out", op_type="output", inputs=["attn"],
                 attrs={"head_names": ["y"]}, out_dim=d))
        G.validate()
    return jg, tg


def _req_kw(dp=3, n=16):
    return dict(design_point=dp, platform="cpu", precision_policy="fp",
                n_hits=n, target_throughput=1e3)


def _op_rows(g):
    return [(op.name, op.op_type, list(op.inputs), op.target, op.segment,
             op.precision, op.template, op.out_dim, op.attrs_opt.get("P"),
             op.attrs_opt.get("variant"), op.attrs_opt.get("bq"),
             op.attrs_opt.get("bk")) for op in g]


@pytest.mark.parametrize("dp,batch", [(1, 1), (2, 1), (3, 1), (3, 2)])
def test_deployed_attention_graph_matches_reference(dp, batch):
    """deploy() of the attention graph: the same graph op for op as the
    reference's, and its output within the float32 row of the
    reference's on both of its backends."""
    jg, tg = _attention_graphs()
    tok = np.random.default_rng(1).normal(size=(4, 16, 8)).astype(
        np.float32)
    tpipe = tdeploy(tg, TReq(**_req_kw(dp)), batch=batch, device="cpu")
    assert tpipe.backend == "cpu"
    got = tpipe({"tok": tok})["y"].numpy()
    assert got.shape == (4, 16, 8)
    for backend in ("xla", "pallas_interpret"):
        jpipe = jdeploy(jg, JReq(**_req_kw(dp)), batch=batch,
                        kernel_backend=backend)
        assert _op_rows(tpipe.graph) == _op_rows(jpipe.graph)
        assert tpipe.microbatch == jpipe.microbatch
        want = np.asarray(jpipe({"tok": jnp.asarray(tok)})["y"])
        assert_close(got, want, dtype="float32", context=backend)


def test_attention_executor_launches_the_bound_blocks(monkeypatch):
    """The executor hands the op's bound (bq, bk) to the flash entry
    point, one call per micro-batch, and the defaults when none is
    bound."""
    from repro_torch.tuning import TuningCache, flash_attention_key
    _, tg = _attention_graphs()
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tpipeline.kops, "flash_attention", spy)
    tok = np.zeros((4, 16, 8), np.float32)
    tdeploy(tg, TReq(**_req_kw()), batch=2, device="cpu")({"tok": tok})
    assert calls == [((2, 16, 8), {"causal": True})] * 2
    cache = TuningCache()
    cache.put(flash_attention_key(2, 16, 16, 8, "float32", "cpu"),
              {"bq": 8, "bk": 16})
    calls.clear()
    tdeploy(tg, TReq(**_req_kw()), batch=2, tuning_cache=cache,
            device="cpu")({"tok": tok})
    assert calls == [((2, 16, 8), {"causal": True, "bq": 8, "bk": 16})] * 2


def test_attention_op_verifies_its_inputs():
    from repro_torch.core.op_registry import GraphVerificationError
    from repro_torch.core.passes.verify import verify
    _, tg = _attention_graphs()
    tg["attn"].inputs = ["q", "k"]
    with pytest.raises(GraphVerificationError, match="q, k, v"):
        verify(tg)
