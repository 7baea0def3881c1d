"""The port's training driver (``python -m repro_torch.launch.train``)
against the JAX package's, on the CPU: the arch registry; the driver
resumed from a reference step-0 checkpoint (its step-1 checkpoint
within the float32 row of the reference's step, leaf by leaf, and five
steps' losses within the bound stated below); ``--inject-failure-at``
bitwise equal to an uninterrupted run; a reference driver's checkpoint
resumed by the port's driver; the captured step driven through a
stand-in capture backend (capture records, replay re-runs into the
same buffers), which catches a restore that rebinds the step's buffers
instead of copying into them; and the refusals (no CUDA without
``--device cpu``, a failed capture, a batch of another shape, the GNN
family, which has no generic stream in either driver). The LM and recsys
families (olmo-1b, granite-moe-1b-a400m, mind): one step of the port's driver from the
reference's step-0 checkpoint against the reference's step (within the
float32 row, leaf by leaf), and a failure injected bitwise equal to an
uninterrupted run.
"""
import contextlib
import io
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from _numerics import assert_close
from test_torch_lm import _two_threads  # noqa: F401 (autouse)

from repro import configs as jconfigs
from repro.checkpoint import manager as jmgr
from repro.launch import train as jtrain
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import manager as tmgr
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as ttrain
from repro_torch.optim.step import CompiledStep

ARCH = "caloclusternet"
#: five steps from one state: the two packages' f32 sums differ in their
#: last bits and the steps carry that forward; 2e-5 relative holds the
#: loss to a few f32 ulps of growth a step
LOSS_RTOL = 2e-5


def _run(argv, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return ttrain.run(["--device", "cpu", "--arch", ARCH, *argv], **kw)


def _reference_step0(ckpt_dir, seed=0, arch=ARCH):
    """The reference driver's state at step 0 (init from PRNGKey(seed)),
    saved as its checkpoint 0."""
    mod = jconfigs.get_arch(arch)
    cfg = mod.smoke_config()
    step, init_params, to_batch, ocfg = jtrain.build_step(arch, mod, cfg)
    params = init_params(jax.random.PRNGKey(seed))
    opt = jadamw_init(params, ocfg)
    jmgr.save(ckpt_dir, 0, {"p": params, "o": opt})
    return mod, cfg, step, to_batch, params, opt


def _leaves(tree):
    return tmgr.flatten(jax.tree_util.tree_map(np.asarray, tree))


def _fields(cfg, ref):
    """The port's config fields equal the reference's (which has more:
    options the port does not take)."""
    return cfg.__dict__ == {k: getattr(ref, k) for k in cfg.__dict__}


# ------------------------------------------------------------ registry ----
def test_registry_ids_and_refusals():
    """All 11 of the reference's ids resolve (DimeNet's and NequIP's
    smoke configs field for field); an unknown id raises. The LM
    configs' fields are compared with their dtypes mapped in
    ``test_torch_lm_configs.py``."""
    assert list(tconfigs._MODULES) == list(jconfigs._MODULES)
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert not hasattr(tconfigs, "NOT_PORTED")
    assert len(tconfigs._MODULES) == 11
    for arch_id in tconfigs._MODULES:
        mod = tconfigs.get_arch(arch_id)
        ref = jconfigs.get_arch(arch_id)
        assert (mod.ARCH_ID, mod.FAMILY, list(mod.SHAPES)) == \
            (ref.ARCH_ID, ref.FAMILY, list(ref.SHAPES))
        if mod.FAMILY != "lm":
            assert _fields(mod.smoke_config(), ref.smoke_config())
    for arch_id in ("dimenet", "nequip"):
        mod = tconfigs.get_arch(arch_id)
        assert mod.smoke_config().__dict__ == \
            jconfigs.get_arch(arch_id).smoke_config().__dict__
        cell, ref = mod.cell("molecule"), jconfigs.get_arch(arch_id).cell(
            "molecule")
        assert (cell.name, cell.kind, cell.model_flops) == \
            (ref.name, ref.kind, ref.model_flops)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("resnet")


def test_ccn_config_flops_match_reference():
    mod, ref = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    for variant in ("upgrade", "current"):
        assert _fields(mod.full_config(variant), ref.full_config(variant))
        assert mod._flops(mod.full_config(variant), 1024) == \
            ref._flops(ref.full_config(variant), 1024)
    assert mod._META == ref._META


def test_gnn_configs_match_reference():
    for arch_id in ("gatedgcn", "graphsage-reddit", "dimenet", "nequip"):
        mod, ref = tconfigs.get_arch(arch_id), jconfigs.get_arch(arch_id)
        for shape in ref.SHAPES:
            cfg, rcfg = mod.full_config(shape), ref.full_config(shape)
            assert _fields(cfg, rcfg), (arch_id, shape)
            meta = mod.__dict__["G"].SHAPES[shape]
            assert meta == ref.__dict__["G"].SHAPES[shape]
            assert mod._flops(meta, cfg) == ref._flops(meta, rcfg)
        assert _fields(mod.smoke_config(), ref.smoke_config())
    sage, rsage = (tconfigs.get_arch("graphsage-reddit"),
                   jconfigs.get_arch("graphsage-reddit"))
    cfg = sage.full_config("minibatch_lg")
    meta = sage.G.SHAPES["minibatch_lg"]
    assert sage._flops_sampled(meta, cfg, 32, 32) == rsage._flops_sampled(
        meta, rsage.full_config("minibatch_lg"), 32, 32)
    assert sage.model.cfg_frontier_sizes(cfg, 32) == (32, 480, 4800)
    assert (sage.G.GROUPS, sage.G.SEEDS_PER_GROUP) == (32, 32)


@pytest.mark.parametrize("arch_id,shapes", [
    ("caloclusternet", {"loss": (), "out.beta_logit": (8, 16),
                        "out.cls_logits": (8, 16, 3), "cps.trigger": (8,)}),
    ("gatedgcn", {"loss": (), "logits": (32, 3), "metrics.acc": ()}),
    ("graphsage-reddit", {"loss": (), "loss_full": (),
                          "metrics.acc": ()}),
    ("olmo-1b", {"loss": (), "logits": (2, 128)}),
    ("mind", {"loss": (), "scores": (16, 300),
              "metrics.in_batch_acc": ()}),
    ("dimenet", {"loss": (), "metrics.energy": ()}),
    ("nequip", {"loss": (), "forces": (20, 3), "metrics.energy": ()})])
def test_smoke_runs(arch_id, shapes):
    """Each config's ``smoke_run`` on the CPU gives finite values of the
    reference's shapes (its weights drawn from a ``torch.Generator``)."""
    got = tconfigs.get_arch(arch_id).smoke_run(seed=0, device="cpu")
    for key, shape in shapes.items():
        v = got
        for part in key.split("."):
            v = v[part]
        assert tuple(v.shape) == shape, key
        assert bool(torch.isfinite(v.float()).all()), key


def test_unported_families_and_gnn_refused(tmp_path):
    """The driver refuses every GNN arch with the reference's ValueError
    for the gnn family (neither driver has a GNN stream)."""
    for arch in ("dimenet", "nequip", "gatedgcn"):
        with pytest.raises(ValueError, match="gnn"):
            _run(["--arch", arch, "--ckpt-dir", str(tmp_path / arch)])
        with pytest.raises(ValueError, match="gnn"):
            jtrain.make_data_stream(arch, jconfigs.get_arch(arch), None, 1,
                                    0, 0)


def test_default_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.run(["--arch", ARCH, "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


# ------------------------------------------- against the reference ----
def test_driver_from_reference_step0_checkpoint(tmp_path):
    """The port's driver resumes the reference's step-0 checkpoint: its
    step-1 checkpoint is the reference's step 1 within the float32 row,
    leaf by leaf; over five steps the losses stay within LOSS_RTOL."""
    one, five = str(tmp_path / "one"), str(tmp_path / "five")
    mod, cfg, jstep, jto_batch, params, opt = _reference_step0(one)
    shutil.copytree(one, five)
    rep = _run(["--steps", "1", "--ckpt-every", "1", "--ckpt-dir", one])
    assert rep.start == 0 and rep.checkpoints == [1]
    stream = jtrain.make_data_stream(ARCH, mod, cfg, 16, 0, 0)
    want_losses = []
    jp, jo = params, opt
    for i in range(5):
        jp, jo, m = jstep(jp, jo, jto_batch(next(stream)))
        want_losses.append(float(m["loss"]))
        if i == 0:
            got, step = tmgr.restore(one, 1, jax.tree_util.tree_map(
                lambda a: torch.zeros(a.shape), {"p": jp, "o": jo}),
                device="cpu")
            assert step == 1
            for (name, g), (_, w) in zip(_leaves(got),
                                         _leaves({"p": jp, "o": jo})):
                assert g.dtype == w.dtype, name
                assert_close(g, w, dtype="float32", context=name)
    rep5 = _run(["--steps", "5", "--ckpt-every", "5", "--ckpt-dir", five])
    got_losses = [v for _, v in rep5.losses]
    assert [s for s, _ in rep5.losses] == [1, 2, 3, 4, 5]
    assert_close(got_losses, want_losses, rtol=LOSS_RTOL, atol=0.0)


def test_reference_driver_checkpoint_resumed_by_port(tmp_path, monkeypatch):
    """A checkpoint of the reference's own driver (step 4 of a 6-step
    run) resumed by the port's driver to step 6: its step-6 state within
    the float32 row of the reference driver's."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--steps", "6", "--ckpt-every", "2",
        "--ckpt-dir", ref_dir])
    with contextlib.redirect_stdout(io.StringIO()):
        jtrain.main()
    os.makedirs(port_dir)
    shutil.copytree(os.path.join(ref_dir, "step_00000004"),
                    os.path.join(port_dir, "step_00000004"))
    rep = _run(["--steps", "6", "--ckpt-every", "2", "--ckpt-dir",
                port_dir])
    assert rep.start == 4 and rep.final_step == 6
    assert rep.checkpoints == [6]
    with open(os.path.join(ref_dir, "step_00000006", "manifest.json")) as f:
        ref_manifest = f.read()
    with open(os.path.join(port_dir, "step_00000006", "manifest.json")) as f:
        port_manifest = f.read()
    strip = (lambda m: [(e["path"], e["file"], e["shape"], e["dtype"])
                        for e in __import__("json").loads(m)["leaves"]])
    assert strip(port_manifest) == strip(ref_manifest)
    like = {"p": rep.params, "o": rep.opt}
    want, _ = tmgr.restore(ref_dir, 6, like)
    # a step moves a parameter by lr·u, |u| about 1 where its gradient is
    # steady; where the gradient is near zero (a head's bias) the last
    # bits of its sum decide u, so the parameters are held to a tenth of
    # the two steps' summed rate, the moments to the float32 row
    # (the reference driver's rate: 3e-4 warmed up over 20 steps, at the
    # step counts 4 and 5 the two steps start from)
    p_atol = 0.1 * sum(3e-4 * s / 20 for s in (4, 5))
    assert int(rep.opt["step"]) == int(want["o"]["step"]) == 6
    for (name, g), (_, w) in zip(tmgr.flatten(like), tmgr.flatten(want)):
        if name.startswith("p/"):
            assert_close(g.numpy(), w.numpy(), rtol=1e-5, atol=p_atol,
                         context=name)
        else:
            assert_close(g.numpy(), w.numpy(), dtype="float32",
                         context=name)


# ---------------------------------------- the LM and recsys families ----
NEW_ARCHS = ["olmo-1b", "granite-moe-1b-a400m", "mind"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_family_one_step_from_reference(arch, tmp_path):
    """The port's driver resumes the reference's step-0 checkpoint of an
    LM or MIND and steps once: its loss, parameters and moments within
    the float32 row of the reference step's, leaf by leaf."""
    ck = str(tmp_path)
    mod, cfg, jstep, jto_batch, params, opt = _reference_step0(ck,
                                                               arch=arch)
    rep = _run(["--arch", arch, "--steps", "1", "--ckpt-every", "1",
                "--ckpt-dir", ck])
    assert rep.start == 0 and rep.checkpoints == [1]
    stream = jtrain.make_data_stream(arch, mod, cfg, 16, 0, 0)
    jp, jo, m = jstep(params, opt, jto_batch(next(stream)))
    assert_close(rep.losses[0][1], float(m["loss"]), dtype="float32")
    want = {"p": jp, "o": jo}
    got, step = tmgr.restore(ck, 1, jax.tree_util.tree_map(
        lambda a: torch.zeros(a.shape), want), device="cpu")
    assert step == 1
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype, name
        assert_close(g, w, dtype="float32", context=name)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_family_failure_equals_uninterrupted(arch, tmp_path):
    argv = ["--arch", arch, "--steps", "4", "--ckpt-every", "2",
            "--batch", "4"]
    broken = _run([*argv, "--inject-failure-at", "3",
                   "--ckpt-dir", str(tmp_path / "a")])
    whole = _run([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert broken.resumes == [(3, 2)]
    assert [s for s, _ in broken.losses] == [1, 2, 3, 3, 4]
    assert all(np.isfinite(v) for _, v in broken.losses)
    for a, b in zip(tmgr.flatten({"p": broken.params, "o": broken.opt}),
                    tmgr.flatten({"p": whole.params, "o": whole.opt})):
        assert torch.equal(a[1], b[1]), a[0]


def test_another_archs_checkpoint_dir_refused(tmp_path):
    """A run resumes what its ``--ckpt-dir`` holds; a checkpoint of
    another arch there is refused by name, not a bare KeyError."""
    _run(["--steps", "1", "--ckpt-every", "1", "--batch", "2",
          "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="another model"):
        _run(["--arch", "mind", "--steps", "2", "--batch", "2",
              "--ckpt-dir", str(tmp_path)])


# ------------------------------------------------ failure injection ----
def test_inject_failure_equals_uninterrupted_bitwise(tmp_path):
    broken = _run(["--steps", "12", "--ckpt-every", "4",
                   "--inject-failure-at", "10",
                   "--ckpt-dir", str(tmp_path / "a")])
    whole = _run(["--steps", "12", "--ckpt-every", "4",
                  "--ckpt-dir", str(tmp_path / "b")])
    assert broken.resumes == [(10, 8)]
    assert [s for s, _ in broken.losses] == [*range(1, 11), 9, 10, 11, 12]
    assert broken.checkpoints == [4, 8, 12] == whole.checkpoints
    for a, b in zip(tmgr.flatten({"p": broken.params, "o": broken.opt}),
                    tmgr.flatten({"p": whole.params, "o": whole.opt})):
        assert torch.equal(a[1], b[1]), a[0]
    for name in os.listdir(tmp_path / "b" / "step_00000012"):
        assert (tmp_path / "a" / "step_00000012" / name).read_bytes() == \
            (tmp_path / "b" / "step_00000012" / name).read_bytes(), name


# ------------------------------------------------- the captured step ----
class FakeGraphs:
    """A stand-in for ``torch.cuda``'s graphs on the CPU: capture runs
    the callable once and keeps it with its outputs as the static
    storage; replay re-runs it and copies its outputs into that storage,
    the launch counters held (a real replay calls no wrapper)."""

    def __init__(self, fail=False):
        self.fail = fail
        self.captured = 0
        self.replayed = 0
        self.warmed = 0

    def warmup(self, fn):
        self.warmed += 1
        return fn()

    def capture(self, fn, pool=None):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        self.captured += 1
        out = fn()
        return (fn, out), out

    def replay(self, graph):
        fn, out = graph
        held = kops.launch_counts()
        new = fn()
        for k in out:
            out[k].copy_(new[k])
        kops.set_launch_counts(held)
        self.replayed += 1


def test_captured_step_equals_eager_and_catches_a_rebinding_restore(
        tmp_path, monkeypatch):
    argv = ["--steps", "12", "--ckpt-every", "4", "--inject-failure-at",
            "10"]
    eager = _run([*argv, "--ckpt-dir", str(tmp_path / "eager")])
    fake = FakeGraphs()
    captured = _run([*argv, "--ckpt-dir", str(tmp_path / "captured")],
                    capture_backend=fake)
    assert captured.captured and not eager.captured
    assert (fake.warmed, fake.captured, fake.replayed) == (1, 1, 14)
    assert captured.losses == eager.losses
    for a, b in zip(tmgr.flatten({"p": captured.params, "o": captured.opt}),
                    tmgr.flatten({"p": eager.params, "o": eager.opt})):
        assert torch.equal(a[1], b[1]), a[0]

    def rebinding_load(self, params, opt):
        self.params, self.opt = params, opt
    monkeypatch.setattr(CompiledStep, "load", rebinding_load)
    wrong = _run([*argv, "--ckpt-dir", str(tmp_path / "wrong")],
                 capture_backend=FakeGraphs())
    assert wrong.losses != eager.losses or any(
        not torch.equal(a[1], b[1]) for a, b in zip(
            tmgr.flatten({"p": wrong.params}),
            tmgr.flatten({"p": eager.params})))


def test_failed_capture_raises(tmp_path):
    with pytest.raises(RuntimeError, match="capturing"):
        _run(["--steps", "2", "--ckpt-dir", str(tmp_path)],
             capture_backend=FakeGraphs(fail=True))


def test_captured_step_refuses_another_shape():
    mod = tconfigs.get_arch(ARCH)
    cfg = mod.smoke_config()
    step, init_params, to_batch, ocfg = ttrain.build_step(ARCH, mod, cfg,
                                                          device="cpu")
    p = init_params(0)
    from repro_torch.optim import adamw_init
    st = CompiledStep(step, p, adamw_init(p, ocfg), device="cpu",
                      backend=FakeGraphs())
    stream = ttrain.make_data_stream(ARCH, mod, cfg, 4, 0, 0)
    st(to_batch(next(stream)))
    st(to_batch(next(stream)))
    assert int(st.opt["step"]) == 2
    other = ttrain.make_data_stream(ARCH, mod, cfg, 5, 0, 0)
    with pytest.raises(ValueError, match="captured for batch"):
        st(to_batch(next(other)))
