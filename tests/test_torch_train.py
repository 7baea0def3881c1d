"""The port's warm-training (the reference's default serve run trains
before it deploys) against the JAX package's, on the CPU: the
condensation loss and its metrics on the same outputs, its gradients
through ``CaloClusterNet.forward`` against ``jax.grad`` of ``ccn.apply``
at the same parameters and batch, one AdamW update (plain and with q8
block-quantized moments), the q8 packing, the cosine warm-up schedule,
the AdamW state's conversion, and the whole 40-step loop of
``launch/serve.py`` at the default config, teacher-forced: each step
starts from the reference's parameters and state of that step.

Tolerances: the ``float32`` row of ``tests/_numerics.py``, except where
a test states another bound and its reason. The events come from the
reference's generator (byte-equal in both packages); the gradient test
takes batches on which both packages' kNN selections agree, so no near
tie swaps a neighbour (``_same_neighbours``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _numerics import assert_bitwise, assert_close

from repro.core import caloclusternet as jccn
from repro.core.condensation import condensation_loss as jloss
from repro.data import belle2 as jbelle2
from repro.kernels import ref as jref
from repro.nn import dense_apply
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.convert import from_jax_adamw_state, from_jax_params
from repro_torch.core import caloclusternet as tccn
from repro_torch.core.condensation import condensation_loss as tloss
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule

STEPS = 40
LABELS = ("object_id", "energy", "cls")
#: batches of the gradient test, drawn clear of near ties
SEED_UPGRADE, SEED_CURRENT = 500, 501


def _configs(detector):
    if detector == "current":
        return (jccn.current_detector_config(),
                tccn.current_detector_config(), jbelle2.current_detector())
    return jccn.CCNConfig(), tccn.CCNConfig(), jbelle2.Belle2Config()


def _jbatch(gen, seed, n=32):
    raw = jbelle2.generate(gen, n, seed=seed)
    return {k: jnp.asarray(v) for k, v in raw.items()
            if k != "trigger_truth"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loss(cfg, batch):
    def lf(params):
        out = jccn.apply(params, batch["feats"], batch["mask"], cfg)
        return jloss(out, {k: batch[k] for k in LABELS}, batch["mask"],
                     k_max=cfg.k_max)
    return lf


# ------------------------------------------------------------------ loss ----
@pytest.mark.parametrize("detector,seed", [("upgrade", 500),
                                           ("upgrade", 531),
                                           ("current", 7)])
def test_condensation_loss_matches_reference(detector, seed):
    """The same outputs (the reference's forward) and labels into both
    losses: the loss and every metric within the float32 row."""
    jcfg, _, gen = _configs(detector)
    params = jccn.init(jax.random.PRNGKey(1), jcfg)
    b = _jbatch(gen, seed)
    out = jccn.apply(params, b["feats"], b["mask"], jcfg)
    want, wm = jloss(out, {k: b[k] for k in LABELS}, b["mask"],
                     k_max=jcfg.k_max)
    tout = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    got, gm = tloss(tout, {k: tb[k] for k in LABELS}, tb["mask"],
                    k_max=jcfg.k_max)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert set(gm) == set(wm)
    for k in wm:
        assert_close(gm[k].item(), float(wm[k]), dtype="float32",
                     context=k)
    assert_close(got.item(), float(want), dtype="float32")


def test_condensation_loss_without_objects_or_noise():
    """Events with no object hit, or no noise hit, take the reference's
    floors (max(count, 1)) and stay finite, equal to the reference's."""
    jcfg = jccn.current_detector_config()
    rng = np.random.default_rng(2)
    n = jcfg.n_hits
    out = {"beta_logit": rng.normal(size=(2, n)).astype(np.float32),
           "coords": rng.normal(size=(2, n, 2)).astype(np.float32),
           "energy": rng.normal(size=(2, n)).astype(np.float32),
           "cls_logits": rng.normal(size=(2, n, 3)).astype(np.float32)}
    obj = np.stack([np.full(n, -1), np.arange(n) % 3]).astype(np.int32)
    labels = {"object_id": obj,
              "energy": rng.uniform(size=(2, n)).astype(np.float32),
              "cls": rng.integers(0, 3, size=(2, n)).astype(np.int32)}
    mask = (rng.uniform(size=(2, n)) < 0.7).astype(np.float32)
    want, wm = jloss({k: jnp.asarray(v) for k, v in out.items()},
                     {k: jnp.asarray(v) for k, v in labels.items()},
                     jnp.asarray(mask), k_max=jcfg.k_max)
    got, gm = tloss({k: torch.from_numpy(v) for k, v in out.items()},
                    {k: torch.from_numpy(v) for k, v in labels.items()},
                    torch.from_numpy(mask), k_max=jcfg.k_max)
    assert np.isfinite(got.item())
    for k in wm:
        assert_close(gm[k].item(), float(wm[k]), dtype="float32",
                     context=k)


# ------------------------------------------------------------- gradients ----
def _port_grads(tparams, tcfg, tb):
    model = tccn.CaloClusterNet(tparams, tcfg)
    leaves = [(n, k, getattr(model.layers[n], k)) for n in tparams
              for k in tparams[n]]
    for *_, t in leaves:
        t.requires_grad_(True)
    out = model(tb["feats"], tb["mask"])
    loss, _ = tloss(out, {k: tb[k] for k in LABELS}, tb["mask"],
                    k_max=tcfg.k_max)
    grads = torch.autograd.grad(loss, [t for *_, t in leaves])
    return loss, {(n, k): g.numpy() for (n, k, _), g in zip(leaves, grads)}


def _same_neighbours(params, b, cfg) -> bool:
    """Whether both packages' kNN selection (the reference's
    ``knn_build_ref`` and the port's plain version, the same argmin and
    knockout as the GravNet cell) picks the same neighbours for every
    valid hit on each GravNet block's projections of this batch, along
    the reference's forward: no near tie swaps one."""
    mask = b["mask"]
    seg = jnp.where(mask > 0, 0, -1).astype(jnp.int32)
    x = dense_apply(params["enc1"], b["feats"], activation=jax.nn.relu)
    x = dense_apply(params["enc2"], x, activation=jax.nn.relu)
    for i in range(cfg.n_gravnet_blocks):
        s = dense_apply(params[f"gn{i}_s"], x)
        f = dense_apply(params[f"gn{i}_flr"], x)
        jidx, jd2 = jax.vmap(
            lambda a, g: jref.knn_build_ref(a, g, k=cfg.k))(s, seg)
        tidx, _ = tref.knn_build_ref(torch.from_numpy(np.array(s)),
                                     torch.from_numpy(np.array(seg)),
                                     k=cfg.k)
        real = (np.asarray(mask) > 0)[..., None] & (np.asarray(jd2) < 5e29)
        if not (tidx.numpy() == np.asarray(jidx))[real].all():
            return False
        agg = jax.vmap(lambda a, g, m: jref.gravnet_aggregate_ref(
            a, g, m, k=cfg.k, scale=cfg.potential_scale))(s, f, mask)
        x = dense_apply(params[f"gn{i}_out"],
                        jnp.concatenate([x, agg], axis=-1),
                        activation=jax.nn.relu)
    return True


@pytest.mark.parametrize("detector,seed", [("upgrade", SEED_UPGRADE),
                                           ("current", SEED_CURRENT)])
def test_gradients_match_jax_grad(detector, seed):
    """Autograd through ``CaloClusterNet.forward`` (its GravNet cell is
    the plain version of the kernels' schedule) and the condensation
    loss against ``jax.grad`` of the reference's ``apply`` and loss:
    every gradient within the float32 row. The batch is one on which
    both packages pick the same neighbours (``_same_neighbours``)."""
    jcfg, tcfg, gen = _configs(detector)
    params = jccn.init(jax.random.PRNGKey(0), jcfg)
    b = _jbatch(gen, seed)
    assert _same_neighbours(params, b, jcfg)
    tparams = from_jax_params(_np(params), tcfg, device="cpu")
    tb = tserve.train_batch(gen, 32, seed, device="cpu")
    (want_loss, _), want = jax.value_and_grad(_jax_loss(jcfg, b),
                                              has_aux=True)(params)
    loss, got = _port_grads(tparams, tcfg, tb)
    assert_close(loss.item(), float(want_loss), dtype="float32")
    for (n, key), g in got.items():
        assert g.shape == np.asarray(want[n][key]).shape
        assert_close(g, np.asarray(want[n][key]), dtype="float32",
                     context=f"{n}/{key}")


# ---------------------------------------------------------------- adamw ----
def _tree(rng, shapes, scale=1.0):
    return {n: {"w": (rng.normal(size=s) * scale).astype(np.float32),
                "b": (rng.normal(size=s[1:]) * scale).astype(np.float32)}
            for n, s in shapes.items()}


@pytest.mark.parametrize("quantize", [False, True],
                         ids=["plain", "q8"])
def test_adamw_update_matches_reference(quantize):
    """Three reference updates build a state with history, then one more
    update in both packages from it: the parameters, the grad norm and
    the moments within the float32 row. The q8 moments: the per-block
    scales within the float32 row and the int8 values within one step
    (a value that lands within rounding of a half rounds either way)."""
    tcfg = tccn.current_detector_config()
    shapes = tccn.param_shapes(tcfg)
    rng = np.random.default_rng(3)
    cfgs = dict(weight_decay=0.01, quantize_states=quantize)
    jcfg, ocfg = jadamw.AdamWConfig(**cfgs), tadamw.AdamWConfig(**cfgs)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(rng, shapes))
    state = jadamw.adamw_init(params, jcfg)
    for _ in range(3):
        g = jax.tree_util.tree_map(jnp.asarray, _tree(rng, shapes, 0.3))
        params, state, _ = jadamw.adamw_update(g, state, params, lr=1e-3,
                                               cfg=jcfg)
    grads = _tree(rng, shapes, 0.3)
    want_p, want_s, want_m = jadamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, grads), state, params,
        lr=jnp.float32(1e-3), cfg=jcfg)
    tp = from_jax_params(_np(params), tcfg, device="cpu")
    ts = from_jax_adamw_state(_np(state), tcfg, device="cpu")
    tg = from_jax_params(grads, tcfg, device="cpu")
    got_p, got_s, got_m = tadamw.adamw_update(
        tg, ts, tp, lr=torch.tensor(1e-3, dtype=torch.float32), cfg=ocfg)
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    assert_close(got_m["grad_norm"].item(), float(want_m["grad_norm"]),
                 dtype="float32")
    for n in shapes:
        for key in ("w", "b"):
            assert_close(got_p[n][key].numpy(), np.asarray(want_p[n][key]),
                         dtype="float32", context=f"{n}/{key}")
            for mom in ("m", "v"):
                g, w = got_s[mom][n][key], want_s[mom][n][key]
                if not quantize:
                    assert_close(g.numpy(), np.asarray(w), dtype="float32",
                                 context=f"{mom}/{n}/{key}")
                    continue
                assert g["q"].dtype == torch.int8
                assert_close(g["scale"].numpy(), np.asarray(w["scale"]),
                             dtype="float32", context=f"{mom}/{n}/{key}")
                dq = np.abs(g["q"].numpy().astype(np.int32)
                            - np.asarray(w["q"]).astype(np.int32))
                assert dq.max() <= 1, f"{mom}/{n}/{key}"


def test_q8_pack_matches_reference_bitwise():
    """The block quantizer on the same f32 values: absmax scales and int8
    values bitwise (the reference's round half to even), the padding of
    the last block, and the unpacked values."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(300, 7)) * np.exp(rng.normal(size=(300, 7)))
         ).astype(np.float32)
    x[:3] = 0.0
    want = jadamw._q8_pack(jnp.asarray(x))
    got = tadamw._q8_pack(torch.from_numpy(x))
    assert got["q"].shape == (9 * 256,) and got["scale"].shape == (9,)
    assert_bitwise(got["scale"].numpy(), np.asarray(want["scale"]))
    assert_bitwise(got["q"].numpy(), np.asarray(want["q"]))
    assert_bitwise(tadamw._q8_unpack(got, (300, 7)).numpy(),
                   np.asarray(jadamw._q8_unpack(want, (300, 7))))


def test_global_norm_and_leaf_order_match_reference():
    tcfg = tccn.current_detector_config()
    tree = _tree(np.random.default_rng(5), tccn.param_shapes(tcfg))
    want = jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    got = tadamw.global_norm(from_jax_params(tree, tcfg, device="cpu"))
    assert_close(got.item(), float(want), dtype="float32")
    leaves = jax.tree_util.tree_leaves(tree)
    for a, b in zip(tadamw.tree_leaves(
            from_jax_params(tree, tcfg, device="cpu")), leaves):
        assert_bitwise(a.numpy(), b)


def test_adamw_state_conversion_refuses_other_layouts():
    tcfg = tccn.current_detector_config()
    params = jccn.init(jax.random.PRNGKey(0), jccn.current_detector_config())
    state = _np(jadamw.adamw_init(params, jadamw.AdamWConfig()))
    ts = from_jax_adamw_state(state, tcfg, device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    bad = dict(state, m={k: v for k, v in state["m"].items()
                         if k != "enc1"})
    with pytest.raises(ValueError, match="enc1"):
        from_jax_adamw_state(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="step"):
        from_jax_adamw_state({"m": state["m"]}, tcfg, device="cpu")
    q8 = _np(jadamw.adamw_init(params,
                               jadamw.AdamWConfig(quantize_states=True)))
    tq = from_jax_adamw_state(q8, tcfg, device="cpu")
    assert tq["v"]["enc1"]["w"]["q"].dtype == torch.int8
    q8["v"]["enc1"]["w"] = {"q": q8["v"]["enc1"]["w"]["q"][:-1],
                            "scale": q8["v"]["enc1"]["w"]["scale"]}
    with pytest.raises(ValueError, match="v/enc1/w"):
        from_jax_adamw_state(q8, tcfg, device="cpu")


# ------------------------------------------------------------- schedule ----
def test_cosine_warmup_matches_reference():
    """The serve run's schedule, at steps 0-40 (as Python ints and as the
    optimizer's int32 step tensor): within the float32 row."""
    kw = dict(peak_lr=2e-3, warmup_steps=10, total_steps=STEPS)
    jlr, tlr = jschedule.cosine_warmup(**kw), tschedule.cosine_warmup(**kw)
    for step in range(STEPS + 1):
        want = float(jlr(step))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = tlr(s)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert_close(got.item(), want, dtype="float32",
                         context=f"step {step}")
    assert tlr(0).item() == 0.0 and abs(tlr(10).item() - 2e-3) < 1e-9


# ------------------------------------------------- the serve run's loop ----
@pytest.fixture(scope="module")
def reference_run():
    """The reference's warm-training of ``python -m repro.launch.serve``
    (``src/repro/launch/serve.py``), step by step at the default config:
    the parameters and AdamW state before each step, and its loss."""
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    cfg, _, gen = _configs("upgrade")
    params = jccn.init(jax.random.PRNGKey(0), cfg)
    ocfg = AdamWConfig(weight_decay=0.01)
    lrf = jschedule.cosine_warmup(peak_lr=2e-3, warmup_steps=10,
                                  total_steps=STEPS)
    opt = adamw_init(params, ocfg)

    @jax.jit
    def step(p, o, b):
        (loss, _), g = jax.value_and_grad(_jax_loss(cfg, b),
                                          has_aux=True)(p)
        p2, o2, _ = adamw_update(g, o, p, lr=lrf(o["step"]), cfg=ocfg)
        return p2, o2, loss

    hist = []
    for st in range(STEPS):
        before = (_np(params), _np(opt))
        params, opt, loss = step(params, opt, _jbatch(gen, 500 + st))
        hist.append((*before, float(loss)))
    hist.append((_np(params), _np(opt), None))
    return hist


#: parameters whose exact gradient is zero: the loss sees the spatial
#: projection s and the cluster coordinates only through differences,
#: so their biases' gradients are rounding noise of either package,
#: which AdamW normalises into steps of up to lr each way
_SHIFT_INVARIANT = {("gn0_s", "b"), ("gn1_s", "b"), ("head_coords", "b")}


@pytest.mark.parametrize("step", range(STEPS))
def test_warm_training_step_teacher_forced(reference_run, step):
    """One step of ``serve.train_step`` from the reference's parameters
    and state of ``step`` (so drift cannot build up), against the
    reference's step: the loss, the new parameters and the moments
    within the float32 row, and the step count. Bound on the
    shift-invariant biases (their exact gradient is zero, see
    ``_SHIFT_INVARIANT``): half an AdamW step, 0.5 · lr of the step."""
    cfg, tcfg, gen = _configs("upgrade")
    p_np, o_np, want_loss = reference_run[step]
    p_next, o_next, _ = reference_run[step + 1]
    tp = from_jax_params(p_np, tcfg, device="cpu")
    to = from_jax_adamw_state(o_np, tcfg, device="cpu")
    ocfg = tadamw.AdamWConfig(weight_decay=0.01)
    lrf = tschedule.cosine_warmup(peak_lr=2e-3, warmup_steps=10,
                                  total_steps=STEPS)
    lr = lrf(to["step"])
    batch = tserve.train_batch(gen, 32, 500 + step, device="cpu")
    got_p, got_o, loss = tserve.train_step(tp, to, batch, cfg=tcfg,
                                           ocfg=ocfg, lr=lr)
    assert_close(loss.item(), want_loss, dtype="float32", context="loss")
    assert int(got_o["step"]) == int(o_next["step"]) == step + 1
    for n in p_next:
        for key in ("w", "b"):
            got = got_p[n][key].numpy()
            if (n, key) in _SHIFT_INVARIANT:
                assert_close(got, p_next[n][key], rtol=0.0,
                             atol=0.5 * lr.item() + 1e-7,
                             context=f"{n}/{key}")
            else:
                assert_close(got, p_next[n][key], dtype="float32",
                             context=f"{n}/{key}")
            for mom in ("m", "v"):
                assert_close(got_o[mom][n][key].numpy(),
                             o_next[mom][n][key], dtype="float32",
                             context=f"{mom}/{n}/{key}")
    # the inputs are left as they were (the update is functional)
    assert_bitwise(tp["enc1"]["w"].numpy(), p_np["enc1"]["w"])


def test_warm_train_runs_the_loop_and_the_loss_falls():
    """``serve.warm_train`` from the port's own seed-0 weights: finite
    parameters of the same layout, a finite last loss below the first
    step's, on the CPU when asked."""
    tcfg, gen = tserve.detector_configs("current")
    p0 = tccn.init(torch.Generator().manual_seed(0), tcfg)
    first = tserve.train_step(
        p0, tadamw.adamw_init(p0, tadamw.AdamWConfig(weight_decay=0.01)),
        tserve.train_batch(gen, 32, 500, device="cpu"), cfg=tcfg,
        ocfg=tadamw.AdamWConfig(weight_decay=0.01), lr=0.0)[2]
    params, losses = tserve.warm_train(tcfg, gen, 12, device="cpu")
    loss = losses[-1]
    assert len(losses) == 12 and losses[0].item() == first.item()
    assert set(params) == set(p0)
    for n in params:
        for key in params[n]:
            assert params[n][key].device.type == "cpu"
            assert params[n][key].shape == p0[n][key].shape
            assert torch.isfinite(params[n][key]).all()
    assert np.isfinite(loss.item()) and loss.item() < first.item()
