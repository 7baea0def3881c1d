"""The port's padding-free ragged path against the JAX package's, on the
CPU: the CSR/bin-packing data layer byte for byte, the raggedized graph
op for op, the plain kNN kernels against the reference's kNN kernels
(through their jnp reference and in interpret mode), the ragged GravNet
block, and ``deploy(ragged=True)`` end to end on the same converted
weights — heads within the float32 row, the kNN ``idx`` and the CPS
decisions bitwise. The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.core import caloclusternet as jccn
from repro.core.graph_ir import Graph as JGraph
from repro.core.graph_ir import Operator as JOperator
from repro.core.op_registry import GraphVerificationError as JGraphError
from repro.core.passes.fusion import fuse as jfuse
from repro.core.passes.parallelize import Requirements as JReq
from repro.core.passes.ragged import raggedize as jraggedize
from repro.core.pipeline import deploy as jdeploy
from repro.data import belle2 as jbelle2
from repro.data import ragged as jragged
from repro.kernels import ops as jops
from repro_torch.convert import from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.graph_ir import Graph as TGraph
from repro_torch.core.graph_ir import Operator as TOperator
from repro_torch.core.op_registry import GraphVerificationError
from repro_torch.core.passes.fusion import fuse as tfuse
from repro_torch.core.passes.ragged import raggedize as traggedize
from repro_torch.core.pipeline import Requirements as TReq
from repro_torch.core.pipeline import deploy as tdeploy
from repro_torch.data import belle2 as tbelle2
from repro_torch.data import ragged as tragged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.knn_build import knn_aggregate_cuda, knn_build_cuda

BACKENDS = ("xla", "pallas_interpret")
N = 32          # the current detector's hit capacity (bin width)
K = 8           # neighbours, as CCNConfig
BIG = 1e30
PROFILES = [(4, 8), (9, 17, 25), (32,)]
COUNT_MIXES = [[0], [0, 0, 0], [N], [N, 0, N], [1, N, 0, 7, N // 2, 0],
               "random"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts(mix):
    if mix == "random":
        return np.random.default_rng(4).integers(0, N + 1, size=20)
    return np.asarray(mix)


def _ragged_pair(counts, d=4, seed=0):
    rng = np.random.default_rng(seed)
    offs = jragged.offsets_from_counts(counts)
    feats = rng.normal(size=(int(offs[-1]), d)).astype(np.float32)
    return (jragged.RaggedBatch(feats, offs),
            tragged.RaggedBatch(feats.copy(), tragged.offsets_from_counts(
                counts)))


def _bytes_equal(a, b, context):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, context
    assert a.tobytes() == b.tobytes(), context


# ------------------------------------------------------------- data layer ----
@pytest.mark.parametrize("mix", COUNT_MIXES, ids=str)
def test_csr_and_bin_packing_byte_equal(mix):
    """CSR round trip, first-fit bin packing (free and pinned bin
    counts) and the scatter back, byte for byte against the reference."""
    counts = _counts(mix)
    jrb, trb = _ragged_pair(counts, seed=len(counts))
    _bytes_equal(trb.offsets, jrb.offsets, "offsets")
    tragged.validate_ragged(trb)
    for got, want in zip(tragged.unpack_events(trb, N),
                         jragged.unpack_events(jrb, N)):
        _bytes_equal(got, want, "unpack_events")
    feats, mask = tragged.unpack_events(trb, N)
    back = tragged.pack_events(feats, mask)
    _bytes_equal(back.feats, trb.feats, "pack_events feats")
    _bytes_equal(back.offsets, trb.offsets, "pack_events offsets")
    assert (tragged.bins_needed(counts, N)
            == jragged.bins_needed(counts, N))
    for n_bins in (None, tragged.bins_needed(counts, N) + 2):
        tb = tragged.bin_pack(trb, N, n_bins=n_bins)
        jb = jragged.bin_pack(jrb, N, n_bins=n_bins)
        for field in ("feats", "mask", "segids", "slots"):
            _bytes_equal(getattr(tb, field), getattr(jb, field), field)
        assert tb.n_events == jb.n_events
        _bytes_equal(
            tragged.unpack_binned(tb.feats, tb.segids, tb.slots,
                                  tb.n_events, N),
            jragged.unpack_binned(jb.feats, jb.segids, jb.slots,
                                  jb.n_events, N), "unpack_binned")
        _bytes_equal(tragged.unpack_binned(tb.feats, tb.segids, tb.slots,
                                           tb.n_events, N), feats,
                     "bin round trip")


def test_group_by_segment_byte_equal():
    vals = np.arange(10)
    segs = np.asarray([2, 0, 1, 0, 2, 1, 0, 2, 1, 0])
    for n_seg in (3, 5):
        for got, want in zip(tragged.group_by_segment(vals, segs, n_seg),
                             jragged.group_by_segment(vals, segs, n_seg)):
            _bytes_equal(got, want, f"group_by_segment n={n_seg}")


@pytest.mark.parametrize("case", ["negative_count", "offsets_short",
                                  "not_monotone", "event_too_big",
                                  "too_few_bins", "segment_out_of_range"])
def test_malformed_ragged_input_raises_in_both(case):
    for mod in (jragged, tragged):
        calls = {
            "negative_count": lambda: mod.offsets_from_counts([-1]),
            "offsets_short": lambda: mod.validate_ragged(mod.RaggedBatch(
                np.zeros((3, 2), np.float32), np.asarray([0, 2]))),
            "not_monotone": lambda: mod.validate_ragged(mod.RaggedBatch(
                np.zeros((3, 2), np.float32), np.asarray([0, 2, 1, 3]))),
            "event_too_big": lambda: mod.bin_pack(mod.RaggedBatch(
                np.zeros((N + 1, 2), np.float32),
                np.asarray([0, N + 1])), N),
            "too_few_bins": lambda: mod.bin_pack(mod.RaggedBatch(
                np.zeros((2 * N, 2), np.float32),
                np.asarray([0, N, 2 * N])), N, n_bins=1),
            "segment_out_of_range": lambda: mod.group_by_segment(
                np.arange(3), np.asarray([0, 1, 2]), 2),
        }
        with pytest.raises(ValueError):
            calls[case]()


def test_generate_ragged_byte_equal():
    jgen = jbelle2.with_occupancy(jbelle2.current_detector(), (9, 17, 25))
    tgen = tbelle2.with_occupancy(tbelle2.current_detector(), (9, 17, 25))
    for want, got in zip(
            [jbelle2.generate_ragged(jgen, 12, seed=5),
             *[next(s) for s in [jbelle2.event_stream_ragged(
                 jgen, 6, seed0=2)] * 2]],
            [tbelle2.generate_ragged(tgen, 12, seed=5),
             *[next(s) for s in [tbelle2.event_stream_ragged(
                 tgen, 6, seed0=2)] * 2]]):
        assert set(got) == set(want)
        _bytes_equal(got["ragged"].feats, want["ragged"].feats, "feats")
        _bytes_equal(got["ragged"].offsets, want["ragged"].offsets,
                     "offsets")
        for k in ("object_id", "energy", "cls", "trigger_truth"):
            _bytes_equal(got[k], want[k], k)
    # the ragged batch is the padded one with its padding stripped
    rb = tbelle2.generate_ragged(tgen, 12, seed=5)["ragged"]
    pad = tbelle2.generate(tgen, 12, seed=5)
    for got, want in zip(tragged.unpack_events(rb, N),
                         (pad["feats"], pad["mask"])):
        _bytes_equal(got, want, "padded round trip")


# ------------------------------------------------------------------ graph ----
@pytest.fixture(scope="module")
def model():
    jcfg = jccn.current_detector_config()
    tcfg = tccn.current_detector_config()
    params = jccn.init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return (jcfg, jccn.to_graph(params, jcfg),
            tcfg, tccn.to_graph(tparams, tcfg))


def _ir_rows(g):
    return [(op.name, op.op_type, list(op.inputs), op.attrs, op.out_dim,
             op.precision) for op in g]


@pytest.mark.parametrize("dp", [1, 3])
def test_raggedized_graph_equals_reference(model, dp):
    """raggedize after the design point's fusion: the same op names,
    types, inputs, attrs and dims as the reference's."""
    _, jg, _, tg = model
    if dp >= 2:
        jg, tg = jfuse(jg, gravnet_block=True), tfuse(tg, gravnet_block=True)
    jr, tr = jraggedize(jg), traggedize(tg)
    assert _ir_rows(tr) == _ir_rows(jr)
    assert tr.meta.get("ragged") is True
    kinds = [op.op_type for op in tr]
    if dp == 1:
        assert (kinds.count("knn_build"), kinds.count("knn_aggregate"),
                kinds.count("gravnet_aggregate")) == (2, 2, 0)
    else:
        assert [op.attrs.get("ragged") for op in tr
                if op.op_type == "gravnet_block"] == [True, True]


@pytest.mark.parametrize("case", ["batchnorm", "segids_taken"])
def test_raggedize_refuses_in_both(case):
    for graph, op, err, ragg in ((JGraph, JOperator, JGraphError,
                                  jraggedize),
                                 (TGraph, TOperator, GraphVerificationError,
                                  traggedize)):
        g = graph()
        name = "segids" if case == "segids_taken" else "x"
        g.add(op(name=name, op_type="input", out_dim=4,
                 attrs={"feature": name}))
        if case == "batchnorm":
            g.add(op(name="bn", op_type="batchnorm", inputs=["x"],
                     out_dim=4))
        with pytest.raises(err):
            ragg(g)


# ---------------------------------------------------------------- kernels ----
def _packed_coords(counts, ds, *, ties, seed):
    """Learned coordinates of events first-fit packed into N-row bins:
    on a coarse dyadic grid (``ties``: every distance exact, many equal,
    so the lowest-column rule decides), or normal draws whose k-th and
    (k+1)-th distances from every row are separated by far more than
    f32 rounding (so both packages choose the same neighbours)."""
    for attempt in range(50):
        rng = np.random.default_rng(seed * 100 + attempt)
        offs = tragged.offsets_from_counts(counts)
        if ties:
            s = rng.integers(-2, 3, size=(int(offs[-1]), ds)) / 2.0
        else:
            s = rng.normal(size=(int(offs[-1]), ds))
        bp = tragged.bin_pack(tragged.RaggedBatch(s.astype(np.float32),
                                                  offs), N)
        if ties or _min_gap(bp.feats, bp.segids) > 1e-3:
            return bp
    raise AssertionError("no well-separated draw in 50 attempts")


def _min_gap(s, segids):
    gap = np.inf
    s = s.astype(np.float64)
    for b in range(s.shape[0]):
        for i in np.flatnonzero(segids[b] >= 0):
            cand = np.flatnonzero(segids[b] == segids[b, i])
            cand = cand[cand != i]
            if len(cand) <= K:
                continue
            d2 = np.sort(((s[b, cand] - s[b, i]) ** 2).sum(1))
            gap = min(gap, (d2[K] - d2[K - 1]) / max(d2[K], 1.0))
    return gap


# bins hold 1-3 events, events with fewer than k+1 hits (exhausted
# slots) and a padded tail
KNN_COUNTS = [12, 3, 17, 30, 1, 9, 20, 5, 26]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ties", [False, True], ids=["separated", "ties"])
def test_knn_build_ref_matches_jax(backend, ties):
    """idx bitwise (exhausted slots included), d2 to the float32 row,
    batched and per bin."""
    bp = _packed_coords(KNN_COUNTS, 4, ties=ties, seed=1)
    assert bp.feats.shape[0] >= 3 and (bp.segids < 0).any()
    widx, wd2 = jops.knn_build_batched(jnp.asarray(bp.feats),
                                       jnp.asarray(bp.segids), k=K,
                                       backend=backend)
    idx, d2 = tref.knn_build_ref(_t(bp.feats), _t(bp.segids), k=K)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert_bitwise(idx.numpy(), np.asarray(widx), context="idx")
    assert_close(d2.numpy(), np.asarray(wd2), dtype="float32",
                 context="d2")
    assert (d2.numpy() == np.float32(BIG)).any()       # exhausted slots
    for b in range(bp.feats.shape[0]):
        bidx, bd2 = jops.knn_build(jnp.asarray(bp.feats[b]),
                                   jnp.asarray(bp.segids[b]), k=K,
                                   backend=backend)
        gidx, gd2 = tops.knn_build(_t(bp.feats[b]), _t(bp.segids[b]), k=K)
        assert_bitwise(gidx.numpy(), np.asarray(bidx), context=f"bin {b}")
        assert_close(gd2.numpy(), np.asarray(bd2), dtype="float32",
                     context=f"bin {b}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_knn_aggregate_ref_matches_jax(backend):
    """The same (idx, d2) into both aggregations: the float32 row,
    batched and per bin."""
    bp = _packed_coords(KNN_COUNTS, 4, ties=False, seed=2)
    widx, wd2 = jops.knn_build_batched(jnp.asarray(bp.feats),
                                       jnp.asarray(bp.segids), k=K,
                                       backend="xla")
    rng = np.random.default_rng(3)
    f = rng.normal(size=(*bp.segids.shape, 22)).astype(np.float32)
    want = jops.knn_aggregate_batched(jnp.asarray(f), widx, wd2,
                                      backend=backend)
    idx, d2 = _t(widx), _t(wd2)
    got = tref.knn_aggregate_ref(_t(f), idx, d2)
    assert got.shape == (*bp.segids.shape, 44)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    assert_bitwise(tops.knn_aggregate_batched(_t(f), idx, d2).numpy(),
                   got.numpy())
    for b in (0, bp.feats.shape[0] - 1):
        bw = jops.knn_aggregate(jnp.asarray(f[b]), widx[b], wd2[b],
                                backend=backend)
        assert_close(tops.knn_aggregate(_t(f[b]), idx[b], d2[b]).numpy(),
                     np.asarray(bw), dtype="float32", context=f"bin {b}")


def test_no_neighbour_crosses_a_segment():
    """Every valid slot names a row of the query's own event, never
    itself or padding; an event of c hits fills min(k, c−1) slots, the
    rest are (0, 1e30); and each event's neighbours, in within-event
    slot coordinates, are those of the event selected alone."""
    counts = [7, N, 12, 5, 20, 1, 2]
    bp = _packed_coords(counts, 3, ties=False, seed=4)
    idx, d2 = (a.numpy() for a in tref.knn_build_ref(_t(bp.feats),
                                                     _t(bp.segids), k=K))
    for b, r in zip(*np.nonzero(bp.segids >= 0)):
        e = bp.segids[b, r]
        valid = d2[b, r] < 0.5 * BIG
        assert valid.sum() == min(K, counts[e] - 1)
        assert not valid[valid.sum():].any()       # valid slots first
        nb = idx[b, r][valid]
        assert (bp.segids[b, nb] == e).all() and (nb != r).all()
        assert (idx[b, r][~valid] == 0).all()
        alone = bp.slots[b] * 0 - 1
        alone[bp.segids[b] == e] = 0
        aidx, ad2 = tref.knn_build_ref(_t(bp.feats[b:b + 1]),
                                       _t(alone[None]), k=K)
        assert_bitwise(bp.slots[b, nb], bp.slots[b, aidx[0, r].numpy()
                                                  ][valid])
        assert_bitwise(d2[b, r], ad2[0, r].numpy())
    # padding rows select nothing
    pad = bp.segids < 0
    assert (d2[pad] == np.float32(BIG)).all() and (idx[pad] == 0).all()


def test_knn_entry_points_route_cpu_tensors_to_plain_versions():
    """A CPU tensor goes to the plain version; the CUDA wrappers refuse
    CPU tensors and count no launch."""
    bp = _packed_coords([10, 20], 4, ties=False, seed=5)
    s, seg = _t(bp.feats), _t(bp.segids)
    counts = knn_build_cuda.launches, knn_aggregate_cuda.launches
    idx, d2 = tops.knn_build_batched(s, seg, k=K)
    ridx, rd2 = tref.knn_build_ref(s, seg, k=K)
    assert_bitwise(idx.numpy(), ridx.numpy())
    assert_bitwise(d2.numpy(), rd2.numpy())
    f = torch.randn(*seg.shape, 6, generator=torch.Generator().manual_seed(0))
    assert_bitwise(tops.knn_aggregate_batched(f, idx, d2).numpy(),
                   tref.knn_aggregate_ref(f, idx, d2).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        knn_build_cuda(s, seg, k=K)
    with pytest.raises(ValueError, match="CUDA"):
        knn_aggregate_cuda(f, idx, d2)
    assert (knn_build_cuda.launches, knn_aggregate_cuda.launches) == counts


def _block_weights(rng, dh=24, ds=4, df=10, dout=24):
    """LeCun-normal weights, the model's scale (|s|² of order 1)."""
    def w(a, b):
        return (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)

    def b(a):
        return (rng.normal(size=(a,)) * 0.1).astype(np.float32)
    return [w(dh, ds), b(ds), w(dh, df), b(df), w(dh + 2 * df, dout),
            b(dout)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_gravnet_block_ragged_matches_reference(backend):
    """The ragged block over packed bins: the float32 row against the
    reference's ``gravnet_block_ragged``; padding rows are zero."""
    for attempt in range(50):
        rng = np.random.default_rng(60 + attempt)
        wts = _block_weights(rng)
        bp = tragged.bin_pack(tragged.RaggedBatch(
            rng.normal(size=(sum(KNN_COUNTS), 24)).astype(np.float32),
            tragged.offsets_from_counts(KNN_COUNTS)), N)
        s = bp.feats.astype(np.float64) @ wts[0] + wts[1]
        if _min_gap(s, bp.segids) > 1e-3:
            break
    want = jops.gravnet_block_ragged(jnp.asarray(bp.feats),
                                     jnp.asarray(bp.segids), *wts, k=K,
                                     backend=backend)
    got = tops.gravnet_block_ragged(_t(bp.feats), _t(bp.segids),
                                    *(_t(a) for a in wts), k=K)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    assert not got.numpy()[bp.segids < 0].any()


# ----------------------------------------------------------------- deploy ----
def _req_kw(cfg, dp, policy="fp"):
    return dict(design_point=dp, platform="cpu", precision_policy=policy,
                n_hits=cfg.n_hits, target_throughput=5e4,
                max_latency_s=2e-3)


def _op_rows(g):
    return [(op.name, op.op_type, op.target, op.segment, op.precision,
             op.attrs_opt.get("P"), op.attrs_opt.get("variant"), op.template)
            for op in g]


def _profile_feeds(occupancies, n_events=8, seed=3):
    gen = jbelle2.with_occupancy(jbelle2.current_detector(), occupancies)
    data = jbelle2.generate(gen, n_events, seed=seed)
    return {"hits": data["feats"], "mask": data["mask"]}


def _assert_outputs_match(got, want, context):
    for h in ("beta", "coords", "energy", "cls"):
        assert got[h].shape == np.asarray(want[h]).shape, h
        assert_close(got[h], np.asarray(want[h]), dtype="float32",
                     context=f"{context}/{h}")
    for k in ("n_clusters", "trigger", "cluster_valid"):
        assert got["cps"][k].dtype == np.asarray(want["cps"][k]).dtype
        assert_bitwise(got["cps"][k], np.asarray(want["cps"][k]),
                       context=f"{context}/cps/{k}")
    for k in ("cluster_xy", "cluster_e", "cluster_beta"):
        assert_close(got["cps"][k], np.asarray(want["cps"][k]),
                     dtype="float32", context=f"{context}/cps/{k}")


@pytest.mark.parametrize("dp", [1, 3])
@pytest.mark.parametrize("occupancies", PROFILES, ids=str)
def test_deployed_ragged_matches_reference(model, dp, occupancies):
    """deploy(ragged=True) on the same converted weights: the deployed
    graphs equal op for op (no retile on knn_build's index tuple), the
    heads of every event within the float32 row, CPS decisions
    bitwise."""
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(jg, JReq(**_req_kw(jcfg, dp)), batch=4, ragged=True)
    tpipe = tdeploy(tg, TReq(**_req_kw(tcfg, dp)), batch=4, ragged=True,
                    device="cpu")
    assert _op_rows(tpipe.pipe.graph) == _op_rows(jpipe.pipe.graph)
    assert (tpipe.microbatch, tpipe.max_events, tpipe.capacity) == (
        jpipe.batch, jpipe.max_events, jpipe.capacity)
    g = tpipe.pipe.graph
    assert not any(op.op_type == "retile" and g[op.inputs[0]].op_type
                   == "knn_build" for op in g)
    kinds = [op.op_type for op in g]
    assert "gravnet_aggregate" not in kinds
    assert kinds.count("knn_build") == (2 if dp == 1 else 0)
    feeds = _profile_feeds(occupancies)
    _assert_outputs_match(tpipe(feeds), jpipe(feeds),
                          f"dp{dp}/{occupancies}")


def test_deployed_ragged_matches_reference_on_interpret(model):
    """One end-to-end run against the reference's Pallas kernel bodies
    (interpret mode)."""
    jcfg, jg, tcfg, tg = model
    feeds = _profile_feeds((9, 17, 25), n_events=4)
    want = jdeploy(jg, JReq(**_req_kw(jcfg, 3)), batch=4, ragged=True,
                   kernel_backend="pallas_interpret")(feeds)
    got = tdeploy(tg, TReq(**_req_kw(tcfg, 3)), batch=4, ragged=True,
                  device="cpu")(feeds)
    _assert_outputs_match(got, want, "pallas_interpret")


def test_ragged_agrees_with_padded_and_takes_csr(model):
    """The port's ragged path equals its padded path on every real row
    (bin packing keeps each event's row order, so every tie-break), with
    the same trigger decisions; a RaggedBatch in gives the padded feeds'
    result bit for bit."""
    _, _, tcfg, tg = model
    gen = tbelle2.with_occupancy(tbelle2.current_detector(), (9, 17, 25))
    data = tbelle2.generate(gen, 12, seed=8)
    feeds = {"hits": data["feats"], "mask": data["mask"]}
    ragged = tdeploy(tg, TReq(**_req_kw(tcfg, 3)), batch=4, ragged=True,
                     device="cpu")
    got = ragged(feeds)
    padded = tdeploy(tg, TReq(**_req_kw(tcfg, 3)), device="cpu")(feeds)
    counts = data["mask"].sum(axis=1).astype(int)
    for h in ("beta", "coords", "energy", "cls"):
        for e, c in enumerate(counts):
            assert_close(got[h][e, :c], padded[h][e, :c].numpy(),
                         dtype="float32", context=f"{h}/event{e}")
            assert not got[h][e, c:].any()
    assert_bitwise(got["cps"]["trigger"], padded["cps"]["trigger"].numpy())
    csr = ragged(tbelle2.generate_ragged(gen, 12, seed=8)["ragged"])
    for h in ("beta", "coords", "energy", "cls"):
        assert_bitwise(csr[h], got[h], context=h)
    assert ragged.warmup() == 1


def test_launch_splitting_never_truncates(model):
    """More events than one launch holds: the plan equals the
    reference's, splits into several launches, and every event comes
    back (max_events caps a launch, not the call)."""
    jcfg, jg, tcfg, tg = model
    jpipe = jdeploy(jg, JReq(**_req_kw(jcfg, 3)), batch=2, ragged=True,
                    max_events=3)
    tpipe = tdeploy(tg, TReq(**_req_kw(tcfg, 3)), batch=2, ragged=True,
                    max_events=3, device="cpu")
    rng = np.random.default_rng(2)
    b = 11
    feeds = {"hits": rng.normal(size=(b, N, tcfg.d_in)).astype(np.float32),
             "mask": (rng.uniform(size=(b, N)) < 0.5).astype(np.float32)}
    counts = feeds["mask"].sum(axis=1).astype(int)
    plan = tpipe._plan_launches(counts)
    assert plan == jpipe._plan_launches(counts)
    assert len(plan) >= 4 and plan[0][0] == 0 and plan[-1][1] == b
    assert all(a == c for (_, a), (c, _) in zip(plan, plan[1:]))
    got = tpipe(feeds)
    assert got["beta"].shape[0] == b and got["cps"]["trigger"].shape == (b,)
    _assert_outputs_match(got, jpipe(feeds), "split")


def test_ragged_under_mixed_raises_in_both(model):
    jcfg, jg, tcfg, tg = model
    with pytest.raises(NotImplementedError):
        jdeploy(jg, JReq(**_req_kw(jcfg, 3, "mixed")), ragged=True)
    with pytest.raises(NotImplementedError):
        tdeploy(tg, TReq(**_req_kw(tcfg, 3, "mixed")), ragged=True,
                device="cpu")
    feeds = _profile_feeds((9, 17))
    with pytest.raises(NotImplementedError):
        tdeploy(tg, TReq(**_req_kw(tcfg, 1, "mixed")), ragged=True,
                calibration_feeds=feeds, device="cpu")


def test_out_of_range_index_selects_zeros():
    """An index outside [0, N) selects a row of zeros, as the reference's
    one-hot product does (its kernel body in interpret mode)."""
    rng = np.random.default_rng(9)
    f = rng.normal(size=(2, N, 6)).astype(np.float32)
    idx = rng.integers(0, N, size=(2, N, K)).astype(np.int32)
    idx[0, 3, 2], idx[1, 5, 0], idx[1, 7, 7] = N, -1, N + 40
    d2 = rng.uniform(0.0, 0.5, size=(2, N, K)).astype(np.float32)
    want = jops.knn_aggregate_batched(jnp.asarray(f), jnp.asarray(idx),
                                      jnp.asarray(d2),
                                      backend="pallas_interpret")
    got = tref.knn_aggregate_ref(_t(f), _t(idx), _t(d2))
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
