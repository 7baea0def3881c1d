"""The port stands alone: importing any module of ``repro_torch`` loads
neither JAX nor the JAX package, no source of the port or of
``chip_smoke.py`` imports them, nothing builds at import time, and an
entry point asked for no device on a host without CUDA raises instead
of running on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS, 'a kernel library loaded at import'\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) == len(_modules()) >= 20


@pytest.mark.parametrize("path", [
    *(p.relative_to(REPO).as_posix() for p in sorted(PKG.rglob("*.py"))),
    "chip_smoke.py"])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(src), path


def test_multi_device_modules_are_covered():
    """The sharding, the cells, the dry-run and its analysis, the
    compressed all-reduce and the meshes are modules of the port, so the
    import and source checks above hold them too; importing them starts
    no process group."""
    assert {"repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.configs.base", "repro_torch.launch.analysis",
            "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.optim.compress"} <= set(_modules())
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.optim.compress\n"
            "import repro_torch.dist.sharding, repro_torch.configs.base\n"
            "assert not dist.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_every_kernel_source_has_its_note():
    """Each CUDA source names the Pallas function it replaces and what
    bounds it on the card."""
    for cu in sorted((PKG / "kernels" / "csrc").glob("*.cu")):
        head = cu.read_text()[:3000]
        assert "Replaces: repro/kernels/" in head, cu.name
        assert "Bound on this card:" in head, cu.name
        assert "Design:" in head, cu.name


def test_kernel_libraries_are_named_by_their_sources(tmp_path,
                                                     monkeypatch):
    """Every csrc/*.cu is a kernel source; its library goes under the
    git-ignored build/ directory and its name changes with the sources,
    so an edited kernel never loads a stale build."""
    from repro_torch.kernels import _build
    assert _build.sources() == ["edge_aggregate", "flash_attention",
                                "fused_dense", "fused_dense_int8",
                                "gravnet_aggregate", "gravnet_block",
                                "gravnet_block_int8", "knn_aggregate",
                                "knn_build"]
    lib = _build._lib_path("gravnet_block")
    assert lib.parent == REPO / "build" / "repro_torch"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()
    fake = tmp_path / "csrc"
    fake.mkdir()
    for p in _build.CSRC.iterdir():
        (fake / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", fake)
    assert _build._lib_path("gravnet_block") == lib
    libs = {n: _build._lib_path(n) for n in _build.sources()}
    with open(fake / "gravnet_cell.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._lib_path("gravnet_block") != lib
    # every kernel that includes the shared cell rebuilds with it
    for n in ("gravnet_aggregate", "gravnet_block_int8", "knn_build",
              "knn_aggregate"):
        assert _build._lib_path(n) != libs[n]


def test_only_the_fma_kernel_builds_without_fmad_false():
    """Every source keeps -fmad=false (its plain version replays its
    bits) except flash_attention, which runs on FMAs and is held to the
    float32 row; each library's name follows its own flags."""
    from repro_torch.kernels import _build
    for name in _build.sources():
        flags = _build.nvcc_flags(name)
        assert ("-fmad=false" in flags) == (name != "flash_attention"), name
        assert "arch=compute_90a,code=sm_90a" in flags


def test_kernel_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_default_device_without_cuda_raises():
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.core.pipeline import Requirements, deploy
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    cfg = ccn.CCNConfig(n_hits=16)
    g = ccn.to_graph(ccn.init(torch.Generator().manual_seed(0), cfg), cfg)
    req = Requirements(design_point=3, platform="cpu",
                       precision_policy="fp", n_hits=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy(g, req)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_warm_training_without_cuda_raises():
    """The optimizer package is part of the port, and the serve loop's
    warm-training, asked for no device on a host without CUDA, raises
    instead of training on the CPU."""
    from repro_torch.launch import serve
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.schedule",
            "repro_torch.core.condensation"} <= set(_modules())
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    cfg, gen_cfg = serve.detector_configs("current")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.warm_train(cfg, gen_cfg, 1)


def test_ragged_deploy_without_cuda_raises():
    """The ragged path's entry point follows the same rule: asked for no
    device on a host without CUDA, deploy(ragged=True) raises before it
    runs anything."""
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.core.pipeline import Requirements, deploy
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    cfg = ccn.CCNConfig(n_hits=16)
    g = ccn.to_graph(ccn.init(torch.Generator().manual_seed(0), cfg), cfg)
    req = Requirements(design_point=3, platform="cpu",
                       precision_policy="fp", n_hits=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy(g, req, batch=8, ragged=True)
    assert type(deploy(g, req, batch=8, ragged=True,
                       device="cpu")).__name__ == "RaggedPipeline"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line on a
    host without CUDA, and in a directory holding nothing else of the
    repository."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, (script, r.stdout, r.stderr)
        assert '"ok"' not in r.stdout


def test_tuning_entry_points_without_cuda_raise():
    """The tuner's default backend is the card: asked for no backend on a
    host without CUDA it raises; warm-up skips a card entry there
    instead of failing."""
    from repro_torch.tuning import (TuningCache, flash_attention_key,
                                    tune_flash_attention, warm_from_cache)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default backend is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_flash_attention(1, 16, 16, 8)
    cache = TuningCache()
    cache.put(flash_attention_key(1, 16, 16, 8, "float32", "cuda"),
              {"bq": 16, "bk": 16})
    with pytest.warns(RuntimeWarning, match="CUDA is not available"):
        assert warm_from_cache(cache) == 0


def test_lm_and_recsys_entry_points_without_cuda_raise(tmp_path):
    """The LM and MIND entry points follow the rule: asked for no device
    on a host without CUDA, they raise instead of running on the CPU."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    assert {"repro_torch.models.transformer", "repro_torch.models.recsys",
            "repro_torch.nn.jax_prng", "repro_torch.data.lm",
            "repro_torch.data.recsys", "repro_torch.configs.mind",
            "repro_torch.configs.lm_common"} <= set(_modules())
    olmo = configs.get_arch("olmo-1b")
    for call in (lambda: tr.init_cache(olmo.smoke_config(), 1, 8),
                 lambda: olmo.smoke_run(),
                 lambda: configs.get_arch("mind").smoke_run()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for arch in ("olmo-1b", "mind"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train.run(["--arch", arch, "--steps", "1",
                       "--ckpt-dir", str(tmp_path / arch)])


def test_geometric_entry_points_without_cuda_raise():
    """DimeNet's and NequIP's entry points and the molecule batch follow
    the rule: asked for no device on a host without CUDA, they raise
    instead of running on the CPU."""
    from repro_torch import configs
    from repro_torch.configs import gnn_common
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid")
    assert {"repro_torch.models.gnn.dimenet", "repro_torch.models.gnn.nequip",
            "repro_torch.models.gnn.sph", "repro_torch.configs.dimenet",
            "repro_torch.configs.nequip"} <= set(_modules())
    for call in (lambda: configs.get_arch("dimenet").smoke_run(),
                 lambda: configs.get_arch("nequip").smoke_run(),
                 lambda: gnn_common.molecule_graphs("nequip", seed=0,
                                                    batch=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
