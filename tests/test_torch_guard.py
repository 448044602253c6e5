"""Guards of the PyTorch port's boundaries: it imports neither jax nor the
JAX package, it never falls back to the CPU when nobody asked for it,
and its kernels build for Hopper (sm_90a) from sources in the repo."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "triton_dist_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return ["triton_dist_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))]


def test_port_modules_import_without_jax():
    mods = _module_names()
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'triton_dist_tpu' or "
              "m.startswith('triton_dist_tpu.'))\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 15


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        # Whole-name match: triton_dist_tpu_torch starts with
        # triton_dist_tpu but is the port itself.
        assert top not in ("jax", "jaxlib", "triton_dist_tpu"), (path, name)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from triton_dist_tpu_torch import default_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_dense_and_engine_need_an_explicit_cpu(no_cuda):
    from triton_dist_tpu_torch.models import DenseLLM, Engine, ModelConfig
    cfg = ModelConfig(hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=8, vocab_size=32,
                      max_position_embeddings=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseLLM(cfg)
    model = DenseLLM(cfg, device="cpu")
    assert Engine(model, batch=1, max_seq=8).device == torch.device("cpu")


def test_gemm_ar_on_a_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """Without a card, a CUDA-typed call reaches the kernel build (and
    fails there) instead of quietly computing on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as ops

    class FakeCuda:
        type = "cuda"

    class FakeTensor:
        device = FakeCuda()
        dtype = torch.bfloat16
        shape = (2, 4)

        def dim(self):
            return 2

        def is_contiguous(self):
            return True

    a, b = FakeTensor(), FakeTensor()
    b.shape = (4, 8)
    monkeypatch.setattr(ops, "gemm_ar_reference", lambda *_: pytest.fail(
        "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises(RuntimeError, match="no build of gemm_ar"):
        ops.gemm_ar(a, b)


def test_flash_decode_on_cuda_tensors_never_takes_the_plain_path(
        monkeypatch):
    """Without a card, CUDA-typed flash-decode calls (each entry point
    and each kernel wrapper) reach the kernel build and fail there
    instead of computing the plain version on the CPU."""
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import flash_decode as fd

    def fake(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    class CudaView:
        """A meta tensor that reports the CUDA device."""

        def __init__(self, t):
            self._t = t
            self.device = torch.device("cuda", 0)
            self.dtype, self.shape = t.dtype, t.shape

        def dim(self):
            return self._t.dim()

        def is_contiguous(self):
            return True

        def element_size(self):
            return self._t.element_size()

        def __getitem__(self, i):
            return CudaView(self._t[i])

    q = CudaView(fake((2, 8, 16)))
    cache = CudaView(fake((2, 32, 2, 16)))
    pool = CudaView(fake((9, 4, 2, 16)))
    table = CudaView(fake((1, 2, 8), torch.int32))
    for name in ("flash_decode_reference", "flash_decode_paged_reference",
                 "flash_decode_partials_reference",
                 "flash_decode_combine_reference"):
        monkeypatch.setattr(fd, name, lambda *_, **__: pytest.fail(
            "CUDA call took the plain version"))

    def refuse(name):
        raise RuntimeError(f"no build of {name}")
    monkeypatch.setattr(_build, "load", refuse)
    calls = [
        lambda: fd.gqa_fwd_batch_decode(
            q, cache, cache, 3, fd.FlashDecodeContext(variant="einsum")),
        lambda: fd.gqa_fwd_batch_decode(
            q, cache, cache, 3, fd.FlashDecodeContext(variant="tiled")),
        lambda: fd.gqa_fwd_batch_decode_paged(q, pool, pool, table, 3),
        lambda: fd.flash_decode_single(q, cache, cache, 3),
        lambda: fd.flash_decode_partial(q, cache, cache, 3, 64, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no build of flash_decode"):
            call()


def test_flash_decode_source_targets_sm90a_without_atomics():
    from triton_dist_tpu_torch.ops import _build
    src = _build.SOURCES["flash_decode"]
    assert src.is_file() and src.is_relative_to(PACKAGE)
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text
    for entry in ("tdt_flash_decode_plan", "tdt_flash_decode_partial",
                  "tdt_flash_decode_combine", "tdt_flash_decode_single"):
        assert entry in text
    for atomic in ("atomicAdd", "atomicMax", "atomicCAS", "atomicExch"):
        assert atomic not in text             # fixed-order sums only


def test_build_command_targets_sm90a_and_sources_exist():
    from triton_dist_tpu_torch.ops import _build
    assert _build.SOURCES and all(p.is_file() and p.is_relative_to(PACKAGE)
                                  for p in _build.SOURCES.values())
    src = _build.SOURCES["gemm_ar"]
    cmd = _build.nvcc_command(src, pathlib.Path("/tmp/out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(src) in cmd
    text = src.read_text()
    assert 'extern "C"' in text and "tdt_gemm_ar" in text
    assert "atomicAdd" not in text          # deterministic split-K
    assert _build.BUILD_DIR.relative_to(PACKAGE)


def test_build_dir_and_sources_are_set_up_for_git_and_packaging():
    ignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "/triton_dist_tpu_torch/_kernels/" in ignore
    assert '"csrc/*.cu"' in (ROOT / "pyproject.toml").read_text()
